"""Pseudo-relevance feedback (RM3-style query expansion): the port of
``tdr/rank/feedback.py``.

A doc-major mirror of the flat CSR (``DocMajorIndex``) is built once per
index on the host; ``prf_expand`` gathers the first pass's top-F feedback
docs' (term, weight) segments on the device, weights each slot by its
doc's normalised first-pass score, sums duplicate terms with a stable sort
and a segment cumsum, masks the query's own terms and appends the top-E
expansion terms with RM3-interpolated weights — so the second pass is the
ordinary scoring engine on a (Q, T+E) batch.

``jax.lax.sort`` is stable and carries its payloads; here that is a
``torch.sort(stable=True)`` and gathers, and the prefix sums follow XLA's
order (``ops.scan.xla_cumsum``), so a term's total equals the JAX one bit
for bit on the CPU.  The two-key sort sorts stably by the second
key, then by the first.  Ties in the top-E choice go to the lower index
(``fast_topk``), as ``lax.top_k`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops.scan import xla_cumsum
from tdr_torch.ops.topk import fast_topk

DEFAULT_FEEDBACK_DOCS = 3
DEFAULT_EXPAND_TERMS = 5
DEFAULT_BETA = 0.3
DEFAULT_MIN_DOCS = 2
# cap on the per-doc segment width: one pathological wide doc would
# otherwise inflate every query's sort (W = F * p_doc slots per query)
MAX_P_DOC = 1024


@dataclass
class DocMajorIndex:
    """Doc-major mirror of a SparseIndex's flat CSR (feedback mining)."""

    terms: torch.Tensor       # (nnz_pad,) int32 term id, doc-major sorted
    w: torch.Tensor           # (nnz_pad,) float32 score weight of the slot
    doc_start: torch.Tensor   # (n_docs_pad + 1,) int32 CSR offsets by doc
    p_doc: int = 0


def build_doc_major(index: SparseIndex, pad_multiple: int = 64) -> DocMajorIndex:
    """One-time inversion of the CSR with numpy on the host, copied to the
    index's device.  ``p_doc`` is the widest doc rounded up to
    ``pad_multiple``; docs wider than ``MAX_P_DOC`` keep their
    ``MAX_P_DOC`` highest-weight terms."""
    indptr = index.indptr.cpu().numpy()
    pd = index.postings_doc.cpu().numpy()
    pw = index.postings_w.cpu().numpy()
    nnz = int(indptr[-1])
    term_of = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int32),
                        np.diff(indptr).astype(np.int64))
    order = np.argsort(pd[:nnz], kind="stable")
    t_s = term_of[order]
    w_s = pw[:nnz][order]
    d_sorted = pd[:nnz][order]
    doc_start = np.searchsorted(
        d_sorted, np.arange(index.n_docs_pad + 1), side="left").astype(np.int32)
    widest = int(np.max(np.diff(doc_start))) if index.n_docs_pad else 1
    if widest > MAX_P_DOC:
        keep = np.ones(nnz, bool)
        lens = np.diff(doc_start)
        for d in np.nonzero(lens > MAX_P_DOC)[0]:
            lo, hi = int(doc_start[d]), int(doc_start[d + 1])
            seg_w = w_s[lo:hi]
            drop = np.argpartition(seg_w, len(seg_w) - MAX_P_DOC)[
                : len(seg_w) - MAX_P_DOC]
            keep[lo + drop] = False
        t_s, w_s, d_sorted = t_s[keep], w_s[keep], d_sorted[keep]
        nnz = t_s.shape[0]
        doc_start = np.searchsorted(
            d_sorted, np.arange(index.n_docs_pad + 1), side="left"
        ).astype(np.int32)
        widest = int(np.max(np.diff(doc_start)))
    t_pad = np.zeros(max(nnz, 1), np.int32)
    w_pad = np.zeros(max(nnz, 1), np.float32)
    t_pad[:nnz] = t_s
    w_pad[:nnz] = w_s
    p_doc = int(np.ceil(max(widest, 1) / pad_multiple)) * pad_multiple
    dev = index.device
    return DocMajorIndex(terms=torch.from_numpy(t_pad).to(dev),
                         w=torch.from_numpy(w_pad).to(dev),
                         doc_start=torch.from_numpy(doc_start).to(dev),
                         p_doc=p_doc)


def prf_mine(dmi: DocMajorIndex, vocab_size: int, qids: torch.Tensor,
             qw: torch.Tensor, w_d: torch.Tensor, rows_f: torch.Tensor,
             finite: torch.Tensor, n_expand: int = DEFAULT_EXPAND_TERMS,
             min_docs: int = DEFAULT_MIN_DOCS, count_rank_clamp: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``n_expand`` (term id, raw pooled total, feedback-doc count) per
    query from one doc-major mirror; invalid slots carry total -inf.
    ``w_d`` (Q, F) are the relevance-model doc weights, ``rows_f`` (Q, F)
    the feedback rows into this index and ``finite`` which are valid.
    ``count_rank_clamp`` > 1 ranks by (min(count, clamp), total)
    lexicographically (the segmented store's pooled mining)."""
    Q, T = qids.shape
    F = w_d.shape[1]
    E, P = n_expand, dmi.p_doc
    dev = qids.device
    rows_f = torch.where(finite, rows_f, torch.zeros_like(rows_f)).long()

    # each feedback doc's (term, weight) segment at width P
    start = dmi.doc_start[rows_f].long()                          # (Q, F)
    dlen = dmi.doc_start[rows_f + 1].long() - start
    offs = torch.arange(P, device=dev)
    m = (offs < dlen[..., None]) & finite[..., None]
    pos = (start[..., None] + offs).clamp(0, dmi.terms.shape[0] - 1)
    g_terms = torch.where(m, dmi.terms[pos],
                          torch.full((), vocab_size, dtype=dmi.terms.dtype,
                                     device=dev))
    g_w = torch.where(m, dmi.w[pos] * w_d[..., None], torch.zeros((), device=dev))

    # duplicate terms across the F docs: stable sort by term, segment sum
    # (cumsum minus run base); the run's last slot carries the total
    W = F * P
    t_s, order = torch.sort(g_terms.reshape(Q, W), dim=1, stable=True)
    w_s = g_w.reshape(Q, W).gather(1, order)
    cs = xla_cumsum(w_s)              # JAX's rounding: see ops/scan.py
    ones = torch.ones((Q, 1), dtype=torch.bool, device=dev)
    change = t_s[:, 1:] != t_s[:, :-1]
    is_first = torch.cat([ones, change], dim=1)
    is_last = torch.cat([change, ones], dim=1)
    base = torch.cummax(torch.where(is_first, cs - w_s,
                                    torch.full_like(cs, float("-inf"))), dim=1)[0]
    total = cs - base

    # each feedback doc holds a term at most once: the run length is the
    # number of feedback docs containing it
    pos_i = torch.arange(W, device=dev).expand(Q, W)
    run_start = torch.cummax(torch.where(is_first, pos_i,
                                         torch.full_like(pos_i, -1)), dim=1)[0]
    run_len = pos_i - run_start + 1

    # mask the terms the query already carries
    present = ((t_s[:, :, None] == qids[:, None, :])
               & (qw > 0)[:, None, :]).any(dim=2)
    cand = torch.where(is_last & (t_s < vocab_size) & ~present & (total > 0)
                       & (run_len >= min_docs), total,
                       torch.full_like(total, float("-inf")))

    if count_rank_clamp <= 1:
        ew, esel = fast_topk(cand, E)
        return t_s.gather(1, esel), ew, run_len.gather(1, esel)
    # (count class, total) descending; invalid slots sink
    ok = torch.isfinite(cand)
    inf = torch.full_like(cand, float("inf"))
    cclass = torch.where(ok, -run_len.clamp(max=count_rank_clamp).float(), inf)
    neg_total = torch.where(ok, -cand, inf)
    o = torch.argsort(neg_total, dim=1, stable=True)
    o = o.gather(1, torch.argsort(cclass.gather(1, o), dim=1, stable=True))[:, :E]
    return t_s.gather(1, o), -neg_total.gather(1, o), run_len.gather(1, o)


def relevance_doc_weights(fb_vals: torch.Tensor, n_feedback: int):
    """(w_d (Q, F), finite (Q, F)): first-pass scores normalised over the
    feedback set (BM25 / tf-idf scores are >= 0)."""
    vals_f = fb_vals[:, :n_feedback]
    finite = torch.isfinite(vals_f) & (vals_f > 0)
    sv = torch.where(finite, vals_f, torch.zeros_like(vals_f))
    w_d = sv / sv.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return w_d, finite


def scale_expansion(ew: torch.Tensor, qw: torch.Tensor, beta: float):
    """RM3 interpolation ``beta * total/max(total) * max(qw)``, in the
    caller's query-weight regime; -inf (invalid) slots get weight 0."""
    ok = torch.isfinite(ew)
    zero = torch.zeros_like(ew)
    norm = torch.where(ok, ew, zero).amax(dim=1, keepdim=True).clamp_min(1e-9)
    qscale = qw.amax(dim=1, keepdim=True).clamp_min(1e-9)
    return ok, torch.where(ok, beta * (ew / norm) * qscale, zero)


def prf_expand(dmi: DocMajorIndex, vocab_size: int, qids: torch.Tensor,
               qw: torch.Tensor, fb_vals: torch.Tensor, fb_rows: torch.Tensor,
               n_expand: int = DEFAULT_EXPAND_TERMS,
               n_feedback: int = DEFAULT_FEEDBACK_DOCS,
               beta: float = DEFAULT_BETA,
               min_docs: int = DEFAULT_MIN_DOCS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RM3 expansion: (qids2 (Q, T+E), qw2 (Q, T+E)), on the device with no
    host read between the two passes."""
    w_d, finite = relevance_doc_weights(fb_vals, n_feedback)
    eterm, ew, _ = prf_mine(dmi, vocab_size, qids, qw, w_d,
                            fb_rows[:, :n_feedback], finite,
                            n_expand=n_expand, min_docs=min_docs)
    ok, e_w = scale_expansion(ew, qw, beta)
    e_t = torch.where(ok, eterm, torch.zeros_like(eterm)).to(qids.dtype)
    return (torch.cat([qids, e_t], dim=1),
            torch.cat([qw, e_w.to(qw.dtype)], dim=1))
