"""Scoring ops over the sparse score-row index: the port of
``tdr/ops/score.py``.

* head terms — the full-head product ``W · head`` (``_head_scores_matmul``),
  the per-term row gather for small batches (``_head_scores_capped``), or
  the fused block-max kernel (``tdr_torch.ops.fused_head``) for
  full-vocab heads;
* tail terms — the compaction kernel (``tdr_torch.ops.tail_compact``), a
  sorted segment cumsum per document, and a top-2k merge with dedupe
  against the head top-k (exact: see ``_fused_topk_core``), at full width
  or, in the exact_compact / approx modes, in two tiers;
* overflowing queries — the exact scatter path;
* candidate re-scoring — ``score_candidates_fused`` (head product and the
  compaction kernel) and ``score_pairs`` (binary search in the CSR).

Indices returned by the top-k functions are int64 (torch's index type).
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops.fused_head import fused_head_topk, query_weight_matrix
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.ops.scan import xla_cumsum
from tdr_torch.ops.tail_compact import tail_compact
from tdr_torch.ops.topk import fast_topk, topk_grouped
from tdr_torch.utils.trace import annotate

NEG_INF = float("-inf")
# query language code that matches every document
WILDCARD_LANG = -2
_HEAD_CHUNK = 16
_CAND_CHUNK = 64      # candidates matched per step in score_candidates_fused


def _pad_topk(vals, idx, top_k: int):
    k = vals.shape[1]
    if k < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, top_k - k))
    return vals, idx


def int8_head_matmul(W: torch.Tensor, rows8: torch.Tensor) -> torch.Tensor:
    """``W_f32 (Q, D) @ rows8_int8 (D, N)`` as an int8 x int8 → int32
    product with the query-side scale folded back out (the per-doc scale is
    still missing; callers multiply by ``head_scale``).  On the card
    ``torch._int_mm`` wants more than 16 rows and a multiple of 8, so the
    int8 queries pad to that."""
    wmax = W.amax(dim=1, keepdim=True)
    integral = (W == torch.round(W)).all(dim=1, keepdim=True) & (wmax <= 127.0)
    qscale = torch.where(integral, torch.ones_like(wmax),
                         wmax.clamp_min(1e-30) / 127.0)
    w8 = torch.round(W / qscale).to(torch.int8)
    Q = w8.shape[0]
    if rows8.is_cuda:
        w8 = torch.nn.functional.pad(w8, (0, 0, 0, max(32, -(-Q // 8) * 8) - Q))
    acc = torch._int_mm(w8, rows8)[:Q]
    return acc.float() * qscale


def head_product(W: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 query weights x (D, N) head rows → (Q, N) f32; an int8
    head's per-doc scale is left to the caller.  On CUDA a bf16 head
    contracts in bf16 with f32 output (a library product: this large
    matmul sits outside any TPU kernel in the JAX package too); on the CPU
    both operands are upcast to f32, which is exact for bf16 inputs.  An f32
    head multiplies in full IEEE f32 whatever the caller's TF32 setting; the
    bf16 and int8 products need no pin (bf16 values are exact in TF32, and
    ``out_dtype=float32`` and ``_int_mm`` accumulate in f32 and int32)."""
    if rows.dtype == torch.int8:
        return int8_head_matmul(W, rows)
    W = W.to(rows.dtype)
    if rows.dtype == torch.float32:
        with ieee_f32():
            return W @ rows
    if rows.is_cuda:
        return torch.mm(W, rows, out_dtype=torch.float32)
    return W.float() @ rows.float()


def _head_scores_matmul(index: SparseIndex, qids: torch.Tensor,
                        qw: torch.Tensor) -> torch.Tensor:
    """Head scores as one full-head product, (Q, N_pad) f32."""
    W, _, _ = query_weight_matrix(index, qids, qw)
    scores = head_product(W, index.head_rows)
    if index.head_rows.dtype == torch.int8:
        scores = scores * index.head_scale[None, :]
    return scores


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
    with ieee_f32():            # the weights are f32 whatever the head's dtype
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


def _tail_compact(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                  budget: int, max_tail_terms: int = 16):
    """The sort compactor: tail posting slots compacted to a static
    ``budget`` per query in two levels, from the term table alone — keep
    at most ``max_tail_terms`` tail terms (a stable T-wide sort, tail
    first), then at most ``budget`` posting slots (a stable sort, active
    first).  Returns (docs (Q, B), vals (Q, B), active (Q, B), overflow
    (Q,)); inactive slots hold doc ``n_docs_pad``.

    The port's tail engine is the ``tail_compact`` kernel; this is its
    plain, independent reference: per query, both give the same multiset
    of (doc, value) slots."""
    Q, T = qids.shape
    P = index.tail_pmax
    dev = qids.device
    q = qids.long()
    slot = index.head_slot[q]
    df = index.stats.df[q].to(torch.int32)
    start = index.indptr[q]
    is_tail = (slot < 0) & (qw > 0)

    # level 1: at most MT tail terms
    MT = min(max_tail_terms, T)
    order = torch.argsort((~is_tail).to(torch.int32), dim=1, stable=True)[:, :MT]
    start_c = start.gather(1, order).long()
    df_c = df.gather(1, order)
    qw_c = qw.gather(1, order)
    tail_c = is_tail.gather(1, order)
    overflow = is_tail.sum(dim=1) > MT

    # level 2: at most ``budget`` posting slots
    offs = torch.arange(P, device=dev)
    active = (offs < df_c[..., None]) & tail_c[..., None]          # (Q, MT, P)
    pos = (start_c[..., None] + offs).reshape(Q, MT * P)
    wq = qw_c[..., None].expand(Q, MT, P).reshape(Q, MT * P)
    active = active.reshape(Q, MT * P)
    B = min(budget, MT * P)
    if B < MT * P:
        overflow = overflow | (active.sum(dim=1) > B)
        # one int32 key: (inactive flag, term index); MT <= 64
        t_idx = torch.arange(MT, device=dev)[:, None].expand(MT, P).reshape(-1)
        key = ((~active).to(torch.int32) << 6) | t_idx.to(torch.int32)
        key, o = torch.sort(key, dim=1, stable=True)
        key, pos = key[:, :B], pos.gather(1, o[:, :B])
        active = (key >> 6) == 0
        wq = qw_c.gather(1, (key & 63).long())
    pos_safe = pos.clamp(0, index.postings_doc.shape[0] - 1)
    docs = torch.where(active, index.postings_doc[pos_safe],
                       torch.full((), index.n_docs_pad, dtype=torch.int32,
                                  device=dev))
    vals = torch.where(active, index.postings_w[pos_safe] * wq,
                       torch.zeros((), device=dev))
    return docs, vals, active, overflow


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


TOPK_MODES = ("exact", "exact_compact", "approx")
# tier-2 bookkeeping of the exact_compact / approx modes, per mode: batches
# through tier 1 and batches whose bound tripped the full-width re-merge
tier2_stats = {m: {"batches": 0, "trips": 0} for m in TOPK_MODES[1:]}


def reset_tier2_stats() -> None:
    for v in tier2_stats.values():
        v.update(batches=0, trips=0)


def _head_at(head: torch.Tensor, d_x: torch.Tensor, n_docs_pad: int):
    return head.gather(1, d_x.clamp(max=n_docs_pad - 1))


def _fused_topk_core(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                     top_k: int, tail_budget: int, n_valid=None,
                     topk_mode: str = "exact", head_engine: str = "matmul"):
    """(vals, docs, overflow); see ``score_and_topk_fused``."""
    if topk_mode not in TOPK_MODES:
        raise ValueError(f"unknown topk_mode {topk_mode!r}")
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
    if topk_mode == "exact_compact" and index.head_size < index.vocab_size:
        # the widened head candidate set tightens tier 1's bound base from
        # hv[k] to hv[k_sel]; grouped-8 selection equals fast_topk exactly
        k_sel = min(max(2 * k, 64), index.n_docs_pad)
        hv, hi = topk_grouped(head, k_sel, group=8)
    else:
        # "approx": lax.approx_max_k is a TPU custom call; tdr falls back
        # to an exact top-k off the TPU, and so does the port
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
    B = docs.shape[1]
    d_s, order = torch.sort(docs, dim=1, stable=True)
    d_s = d_s.long()
    v_s = v_enc.gather(1, order)
    m_s = v_s >= 0
    v_s = v_s.clamp_min(0.0)

    # one launch on the card; on the CPU, XLA's blocked order, so that the
    # tail sums equal the JAX package's bit for bit (see ops/scan.py)
    cs = torch.cumsum(v_s, dim=1) if v_s.is_cuda else xla_cumsum(v_s)
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
    neg = torch.full((), NEG_INF, device=dev)

    if topk_mode == "exact_compact":
        m_cut = min(B, max(256, index.tail_pmax))
    else:
        m_cut = min(B, max(512, 2 * index.tail_pmax))
    if topk_mode != "exact" and m_cut < B:
        # tier 1: the M live slots with the largest tail sums; tau bounds
        # the tail of every dropped doc.  Head candidates get their exact
        # totals: each one's run end is binary-searched in the doc-sorted
        # slots and its tail sum added.
        lkey = torch.where(live, -tail_sum, torch.full_like(tail_sum, float("inf")))
        lkey_s, lo = torch.sort(lkey, dim=1, stable=True)
        live_c = torch.isfinite(lkey_s[:, :m_cut])
        kM = lkey_s[:, m_cut]
        tau = torch.where(torch.isfinite(kM), -kM, torch.zeros_like(kM)).clamp_min(0.0)
        d_c = d_s.gather(1, lo[:, :m_cut])
        ts_c = tail_sum.gather(1, lo[:, :m_cut])
        posr = torch.searchsorted(d_s, hi.contiguous(), right=True) - 1
        posr_c = posr.clamp(0, B - 1)
        hit = (posr >= 0) & (d_s.gather(1, posr_c) == hi) & m_s.gather(1, posr_c)
        hv_k = hv[:, -1]                      # the bound base: hv[k] or hv[k_sel]
        hv = hv + torch.where(hit, tail_sum.gather(1, posr_c),
                              torch.zeros((), device=dev))
        t1_vals, t1_docs = _merge(
            d_c, torch.where(live_c, _head_at(head, d_c, index.n_docs_pad)
                             + ts_c, neg), hv, hi, k)
        # every candidate's value is exact, and a non-candidate doc scores
        # at most hv_k + tau: if the k-th value beats that, tier 1 is exact.
        # Otherwise tier 2 re-merges with every live slot.  A host branch
        # on the flag (lax.cond in the JAX code): this reads one bool back,
        # so it syncs with the device once per batch.
        flag = (t1_vals[:, k - 1] < hv_k + tau).any()
        with annotate("tdr_torch.sync.tier2"):
            risky = bool(flag)
        st = tier2_stats[topk_mode]
        st["batches"] += 1
        if risky:
            st["trips"] += 1
            vals_out, docs_out = _merge(
                d_s, torch.where(live, _head_at(head, d_s, index.n_docs_pad)
                                 + tail_sum, neg), hv, hi, k)
        else:
            vals_out, docs_out = t1_vals, t1_docs
    else:
        cand = torch.where(live, _head_at(head, d_s, index.n_docs_pad)
                           + tail_sum, neg)
        vals_out, docs_out = _merge(d_s, cand, hv, hi, k)
    vals_out, docs_out = _pad_topk(vals_out, docs_out, top_k)
    return vals_out, docs_out, overflow


def score_and_topk_fused(index: SparseIndex, qids: torch.Tensor,
                         qw: torch.Tensor, top_k: int = 10,
                         tail_budget: int = 2048, tail_engine: str = "xla",
                         n_valid=None, topk_mode: str = "exact",
                         head_engine: str = "matmul"):
    """Exact top-k without the tail scatter: score(d) = head(d) + tail(d),
    with the tail compacted to a budget per query before any gather and
    merged with the head top-k by a top-2k + dedupe.  Queries over the
    head-term cap or the tail budget are re-scored by the exact scatter
    path.

    ``head_engine``: "matmul" (full-head product), "gather" (per-term rows,
    for small batches) or "fused" (the block-max kernel, full-vocab heads).
    ``topk_mode``: "exact" (full-width merge), "exact_compact" (``max(2k,
    64)`` widened head candidates, grouped-8 selection, a tier-1 merge of
    the ``max(256, tail_pmax)`` largest tail sums checked by a bound, and a
    full-width tier 2 when it trips) or "approx" (the same tiers at ``k``
    head candidates and ``max(512, 2 tail_pmax)`` tail sums; exact here, as
    in ``tdr`` off the TPU).
    ``tail_engine`` takes any of ``tdr``'s values ("auto", "xla", "pallas",
    "pallas_interpret") and changes nothing: the port has one tail engine,
    the ``tail_compact`` kernel on the card (its plain version on the CPU).
    """
    vals, docs, overflow = _fused_topk_core(index, qids, qw, top_k,
                                            tail_budget, n_valid, topk_mode,
                                            head_engine)
    # host branch on the flag (lax.cond in the JAX code): this reads one
    # bool back, so it syncs with the device once per batch
    flag = overflow.any()
    with annotate("tdr_torch.sync.overflow"):
        overflowed = bool(flag)
    if overflowed:
        sv, sd = _scatter_topk(index, qids, qw, top_k, n_valid)
        vals = torch.where(overflow[:, None], sv, vals)
        docs = torch.where(overflow[:, None], sd, docs)
    return vals, docs


def score_candidates_fused(index: SparseIndex, qids: torch.Tensor,
                           qw: torch.Tensor, cand: torch.Tensor,
                           tail_budget: int = 2048, tail_engine: str = "xla"
                           ) -> torch.Tensor:
    """(Q, C) scores for explicit candidate rows: the full-head product
    gathered at the candidates, plus the ``tail_compact`` kernel's slots
    matched against the candidates by an equality-weighted sum.  Matches
    ``score_pairs`` up to the head's dtype rounding (bf16 heads); exact for
    f32 heads.  Queries whose tail overflows the budget take
    ``score_pairs`` rows.  ``tail_engine`` changes nothing, as in
    ``score_and_topk_fused``."""
    Q, C = cand.shape
    qids = qids.clamp(0, index.vocab_size - 1)
    cand = cand.long()
    head = _head_scores_matmul(index, qids, qw)                # (Q, N)
    head_at = head.gather(1, cand.clamp(0, index.n_docs_pad - 1))
    if index.head_size >= index.vocab_size:
        return head_at                                         # empty tail
    budget = min(max(tail_budget, 4 * index.tail_pmax), 16 * index.tail_pmax)
    docs, v_enc, overflow = tail_compact(index, qids, qw, budget)
    v_pos = v_enc.clamp_min(0.0)                               # dead lanes -> 0
    tail_at = torch.empty((Q, C), dtype=torch.float32, device=head.device)
    zero = torch.zeros((), device=head.device)
    for c0 in range(0, C, _CAND_CHUNK):
        cc = cand[:, c0:c0 + _CAND_CHUNK]
        eq = docs[:, None, :] == cc[:, :, None]                # (Q, CH, W)
        tail_at[:, c0:c0 + cc.shape[1]] = torch.where(
            eq, v_pos[:, None, :], zero).sum(dim=2)
    fused = head_at + tail_at
    # host branch on the flag (lax.cond in the JAX code): one bool read back
    flag = overflow.any()
    with annotate("tdr_torch.sync.overflow"):
        overflowed = bool(flag)
    if overflowed:
        exact = score_pairs(index, qids, qw, cand)
        fused = torch.where(overflow[:, None], exact, fused)
    return fused


def score_pairs(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                cand: torch.Tensor) -> torch.Tensor:
    """(Q, C) scores of explicit (query, candidate-doc) pairs from the CSR
    alone: postings within a term are doc-sorted, so each (term, doc)
    weight is found by a 32-step binary search in the term's segment (the
    JAX code's steps, so the positions are the same).  f32-exact."""
    Q, T = qids.shape
    C = cand.shape[1]
    q = qids.clamp(0, index.vocab_size - 1).long()
    start = index.indptr[q].long()                             # (Q, T)
    df = index.stats.df[q].to(torch.int64)
    valid = qw > 0
    docs_sorted = index.postings_doc
    nnz = docs_sorted.shape[0]
    lo = start[:, :, None].expand(Q, T, C)
    hi = lo + df[:, :, None]
    target = cand.to(docs_sorted.dtype)[:, None, :].expand(Q, T, C)
    for _ in range(32):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = docs_sorted[mid.clamp(0, nnz - 1)] < target
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    found = lo.clamp(0, nnz - 1)
    hit = ((lo < (start + df)[:, :, None]) & (docs_sorted[found] == target)
           & valid[:, :, None])
    w = torch.where(hit, index.postings_w[found], torch.zeros((), device=qw.device))
    return (w * qw[:, :, None]).sum(dim=1)


def score_batch(index: SparseIndex, qids: torch.Tensor,
                qw: torch.Tensor) -> torch.Tensor:
    """Full score matrix (Q, N_pad); docs >= n_docs score -inf."""
    return mask_invalid_docs(score_batch_raw(index, qids, qw), index.n_docs)


def topk_masked(scores: torch.Tensor, k: int):
    return fast_topk(scores, k)


def _topk_2stage(scores: torch.Tensor, k: int, block: int = 1024):
    """Exact top-k in two passes (block top-k, then top-k of the winners),
    in ``lax.top_k``'s order; the JAX code keeps it off its main path."""
    Q, N = scores.shape
    if k > block or N < 4 * block or N % block:
        return fast_topk(scores, k)
    nb = N // block
    v1, i1 = fast_topk(scores.view(Q, nb, block), k)           # (Q, nb, k)
    base = torch.arange(nb, device=scores.device)[None, :, None] * block
    gi = (i1 + base).reshape(Q, nb * k)
    v2, sel = fast_topk(v1.reshape(Q, nb * k), k)
    return v2, gi.gather(1, sel)


def topk_language_filtered(scores: torch.Tensor, doc_langs: torch.Tensor,
                           query_langs: torch.Tensor, top_k: int = 10):
    """Top-k over the docs whose language code matches the query's; a
    query code of ``WILDCARD_LANG`` ranks every doc."""
    q = query_langs[:, None]
    mask = (doc_langs[None, :] == q) | (q == WILDCARD_LANG)
    return fast_topk(torch.where(mask, scores,
                                 torch.full((), NEG_INF, device=scores.device)),
                     top_k)
