"""Scoring ops over the sparse score-row index, exact mode: the port of
``tdr/ops/score.py``.

* head terms — the full-head product ``W · head`` (``_head_scores_matmul``),
  the per-term row gather for small batches (``_head_scores_capped``), or
  the fused block-max kernel (``tdr_torch.ops.fused_head``) for
  full-vocab heads;
* tail terms — the compaction kernel (``tdr_torch.ops.tail_compact``), a
  sorted segment cumsum per document, and a top-2k merge with dedupe
  against the head top-k (exact: see ``_fused_topk_core``);
* overflowing queries — the exact scatter path.

Indices returned by the top-k functions are int64 (torch's index type).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops.fused_head import fused_head_topk, query_weight_matrix
from tdr_torch.ops.tail_compact import tail_compact
from tdr_torch.ops.topk import fast_topk

NEG_INF = float("-inf")
_HEAD_CHUNK = 16


def _pad_topk(vals, idx, top_k: int):
    k = vals.shape[1]
    if k < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, top_k - k))
    return vals, idx


def int8_head_matmul(W: torch.Tensor, rows8: torch.Tensor) -> torch.Tensor:
    """``W_f32 (Q, D) @ rows8_int8 (D, N)`` as an int8 x int8 → int32
    product with the query-side scale folded back out (the per-doc scale is
    still missing; callers multiply by ``head_scale``)."""
    wmax = W.amax(dim=1, keepdim=True)
    integral = (W == torch.round(W)).all(dim=1, keepdim=True) & (wmax <= 127.0)
    qscale = torch.where(integral, torch.ones_like(wmax),
                         wmax.clamp_min(1e-30) / 127.0)
    w8 = torch.round(W / qscale).to(torch.int8)
    acc = torch._int_mm(w8, rows8)
    return acc.float() * qscale


def _head_scores_matmul(index: SparseIndex, qids: torch.Tensor,
                        qw: torch.Tensor) -> torch.Tensor:
    """Head scores as one full-head product, (Q, N_pad) f32.  On CUDA a bf16
    head contracts in bf16 with f32 output (a library product: this large
    matmul sits outside any TPU kernel in the JAX package too); on the CPU
    both operands are upcast to f32, which is exact for bf16 inputs."""
    W, _, _ = query_weight_matrix(index, qids, qw)
    rows = index.head_rows
    if rows.dtype == torch.int8:
        return int8_head_matmul(W, rows) * index.head_scale[None, :]
    W = W.to(rows.dtype)
    if rows.dtype == torch.float32:
        return W @ rows
    if rows.is_cuda:
        return torch.mm(W, rows, out_dtype=torch.float32)
    return W.float() @ rows.float()


def _head_scores_capped(index: SparseIndex, qids: torch.Tensor,
                        qw: torch.Tensor, max_terms: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head scores from the active terms' rows, the term loop capped at
    ``max_terms``: reads about T head rows instead of the whole head (the
    serving engine for Q <= 8).  Returns (scores, overflow) where overflow
    flags queries with more active head terms than the cap."""
    Q, T = qids.shape
    slot = index.head_slot[qids.long()].long()
    active = (slot >= 0) & (qw > 0)
    order = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    slot_c = torch.where(active, slot, 0).gather(1, order)
    w_eff = torch.where(active, qw, torch.zeros_like(qw)).gather(1, order)
    TH = min(max_terms, T)
    overflow = active.sum(dim=1) > TH
    slot_c, w_eff = slot_c[:, :TH], w_eff[:, :TH]

    rows = index.head_rows
    scores = torch.zeros((Q, index.n_docs_pad), dtype=torch.float32,
                         device=rows.device)
    for c0 in range(0, TH, _HEAD_CHUNK):
        s = slot_c[:, c0:c0 + _HEAD_CHUNK]
        w = w_eff[:, c0:c0 + _HEAD_CHUNK]
        scores = scores + torch.bmm(w[:, None, :], rows[s].float())[:, 0]
    if rows.dtype == torch.int8:
        scores = scores * index.head_scale[None, :]
    return scores, overflow


def _tail_scores(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                 scores: torch.Tensor) -> torch.Tensor:
    """Scatter-add the flat-CSR tail postings into scores (Q, N_pad)."""
    Q, T = qids.shape
    P = index.tail_pmax
    q = qids.long()
    slot = index.head_slot[q]
    df = index.stats.df[q]
    start = index.indptr[q].long()
    is_tail = (slot < 0) & (qw > 0)
    offs = torch.arange(P, device=qids.device)
    pos = start[..., None] + offs                              # (Q, T, P)
    mask = (offs < df[..., None]) & is_tail[..., None]
    pos_c = pos.clamp(0, index.postings_doc.shape[0] - 1)
    docs = torch.where(mask, index.postings_doc[pos_c], 0).long()
    vals = torch.where(mask, index.postings_w[pos_c] * qw[..., None],
                       torch.zeros((), device=qids.device))
    q_idx = torch.arange(Q, device=qids.device)[:, None, None].expand(Q, T, P)
    flat = (q_idx * scores.shape[1] + docs).reshape(-1)
    out = scores.reshape(-1).clone()
    out.index_add_(0, flat, vals.reshape(-1))
    return out.view_as(scores)


def score_batch_raw(index: SparseIndex, qids: torch.Tensor,
                    qw: torch.Tensor) -> torch.Tensor:
    """Unmasked score matrix (Q, N_pad); padding docs score 0."""
    qids = qids.clamp(0, index.vocab_size - 1)
    return _tail_scores(index, qids, qw, _head_scores_matmul(index, qids, qw))


def mask_invalid_docs(scores: torch.Tensor, n_valid) -> torch.Tensor:
    """-inf out doc columns >= n_valid."""
    doc = torch.arange(scores.shape[1], device=scores.device)[None, :]
    return torch.where(doc < n_valid, scores,
                       torch.full((), NEG_INF, device=scores.device))


def _scatter_topk(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                  top_k: int, n_valid=None):
    scores = mask_invalid_docs(score_batch_raw(index, qids, qw),
                               index.n_docs if n_valid is None else n_valid)
    vals, idx = fast_topk(scores, min(top_k, index.n_docs_pad))
    return _pad_topk(vals, idx, top_k)


def score_and_topk(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                   top_k: int = 10):
    """Batched top-k (vals, doc rows) through the full score matrix; padded
    with (-inf, 0) when top_k exceeds the padded doc count."""
    return _scatter_topk(index, qids, qw, top_k)


def _tail_compact(*args, **kwargs):
    raise NotImplementedError(
        "the sort compactor is not ported yet; the port's tail engine is "
        "tdr_torch.ops.tail_compact")


def _merge(cand_docs, cand_vals, hv, hi, k: int):
    """top-k of the head candidates ++ tail candidates, deduped.  Exact:
    any true top-k doc's exact entry ranks <= 2k-1 in the merged list."""
    all_vals = torch.cat([hv, cand_vals], dim=1)
    all_docs = torch.cat([hi, cand_docs], dim=1)
    k2 = min(2 * k, all_vals.shape[1])
    mv, msel = fast_topk(all_vals, k2)
    mdocs = all_docs.gather(1, msel)
    tri = torch.ones((k2, k2), dtype=torch.bool, device=hv.device).tril(-1)
    dup = ((mdocs[:, :, None] == mdocs[:, None, :]) & tri).any(dim=2)
    sel = torch.argsort(dup.to(torch.int32), dim=1, stable=True)[:, :k]
    return mv.gather(1, sel), mdocs.gather(1, sel)


def _fused_topk_core(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                     top_k: int, tail_budget: int, n_valid=None,
                     topk_mode: str = "exact", head_engine: str = "matmul"):
    """(vals, docs, overflow) in exact mode; see ``score_and_topk_fused``."""
    if topk_mode != "exact":
        raise NotImplementedError(
            f"topk_mode={topk_mode!r} is not ported yet (only 'exact')")
    qids = qids.clamp(0, index.vocab_size - 1)
    Q = qids.shape[0]
    dev = qids.device
    no_overflow = torch.zeros(Q, dtype=torch.bool, device=dev)

    if head_engine == "gather":
        head, overflow_h = _head_scores_capped(index, qids, qw, _HEAD_CHUNK)
    elif head_engine == "fused":
        if index.head_size < index.vocab_size:
            raise ValueError("the fused head engine needs a full-vocab head")
        k = min(top_k, index.n_docs_pad)
        hv, hi = fused_head_topk(index, qids, qw, top_k=k, n_valid=n_valid)
        hv, hi = _pad_topk(hv, hi, top_k)
        return hv, hi, no_overflow
    elif head_engine == "matmul":
        head = _head_scores_matmul(index, qids, qw)
        overflow_h = no_overflow
    else:
        raise ValueError(f"unknown head_engine {head_engine!r}")
    head = mask_invalid_docs(head, index.n_docs if n_valid is None else n_valid)
    k = min(top_k, index.n_docs_pad)
    hv, hi = fast_topk(head, k)

    # full-vocab head: the tail is empty, scoring is the head top-k
    if index.head_size >= index.vocab_size:
        hv, hi = _pad_topk(hv, hi, top_k)
        return hv, hi, overflow_h

    # compacted tail slots → per-doc tail sums via a sorted segment cumsum;
    # the budget is floored at 4x the widest tail posting list
    budget = min(max(tail_budget, 4 * index.tail_pmax), 16 * index.tail_pmax)
    docs, v_enc, overflow = tail_compact(index, qids, qw, budget)
    overflow = overflow | overflow_h
    d_s, order = torch.sort(docs, dim=1, stable=True)
    v_s = v_enc.gather(1, order)
    m_s = v_s >= 0
    v_s = v_s.clamp_min(0.0)

    cs = torch.cumsum(v_s, dim=1)
    cs_excl = cs - v_s
    ones = torch.ones((Q, 1), dtype=torch.bool, device=dev)
    change = d_s[:, 1:] != d_s[:, :-1]
    is_first = torch.cat([ones, change], dim=1)
    is_last = torch.cat([change, ones], dim=1)
    # run base propagated right by a running max (weights are >= 0, so the
    # exclusive cumsum at each run start is non-decreasing)
    base = torch.cummax(torch.where(is_first, cs_excl,
                                    torch.full_like(cs_excl, NEG_INF)), dim=1)[0]
    tail_sum = cs - base                                        # valid at is_last
    live = is_last & m_s
    head_at = head.gather(1, d_s.long().clamp(max=index.n_docs_pad - 1))
    cand = torch.where(live, head_at + tail_sum,
                       torch.full_like(tail_sum, NEG_INF))
    vals_out, docs_out = _merge(d_s.long(), cand, hv, hi, k)
    vals_out, docs_out = _pad_topk(vals_out, docs_out, top_k)
    return vals_out, docs_out, overflow


def score_and_topk_fused(index: SparseIndex, qids: torch.Tensor,
                         qw: torch.Tensor, top_k: int = 10,
                         tail_budget: int = 2048, n_valid=None,
                         topk_mode: str = "exact",
                         head_engine: str = "matmul"):
    """Exact top-k without the tail scatter: score(d) = head(d) + tail(d),
    with the tail compacted to a budget per query before any gather and
    merged with the head top-k by a top-2k + dedupe.  Queries over the
    head-term cap or the tail budget are re-scored by the exact scatter
    path.

    ``head_engine``: "matmul" (full-head product), "gather" (per-term rows,
    for small batches) or "fused" (the block-max kernel, full-vocab heads).
    """
    vals, docs, overflow = _fused_topk_core(index, qids, qw, top_k,
                                            tail_budget, n_valid, topk_mode,
                                            head_engine)
    # host branch on the flag (lax.cond in the JAX code): this reads one
    # bool back, so it syncs with the device once per batch
    if bool(overflow.any()):
        sv, sd = _scatter_topk(index, qids, qw, top_k, n_valid)
        vals = torch.where(overflow[:, None], sv, vals)
        docs = torch.where(overflow[:, None], sd, docs)
    return vals, docs


def score_candidates_fused(*args, **kwargs):
    raise NotImplementedError("score_candidates_fused is not ported yet")


def score_pairs(*args, **kwargs):
    raise NotImplementedError("score_pairs is not ported yet")
