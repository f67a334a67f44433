"""Vocab-axis tensor parallelism for the sparse head (from
``tdr/parallel/vocab_tp.py``).

A full-vocab head makes scoring one (Q, D) x (D, N) product, and TP over
the vocab axis is matmul tensor parallelism:

* ``head_rows`` is split along the head-slot (D) axis: device i holds
  (D/S, N), 1/S of the head;
* each device scatters the query weights of the terms whose slot falls in
  its range and computes a partial (Q, N) score matrix;
* ``psum_scatter`` over the doc axis leaves device i the summed (Q, N/S)
  slice, so the full matrix is never replicated;
* a local top-k per doc slice, then a gather of the (Q, k) candidates and
  a global merge.

**Hybrid** (a tail-bearing index): the head is slot-sharded as above and
the tail CSR is replicated on every device (the head rows stripped).
After the collective, device i compacts the batch's tail postings with the
``tail_compact`` kernel (the single-device tail engine; ``tdr`` calls its
XLA sort compactor here) and adds those whose doc falls in its slice.  A
batch with a query over the compaction's budget takes the exact in-range
postings scatter (``exact_tail``) on every device instead.

Each device's partial is the single-device head product
(``ops.score.head_product``); an int8 head multiplies int8 x int8 -> int32,
and the per-doc-column scale is applied after the collective, to each
device's own slice.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdr_torch.index.build import IndexStats, SparseIndex, _round_up
from tdr_torch.ops.score import NEG_INF, head_product
from tdr_torch.ops.tail_compact import tail_compact
from tdr_torch.ops.topk import fast_topk, sort_desc_by_value_then_index
from tdr_torch.parallel.mesh import Mesh, _copy, all_gather, psum_scatter
from tdr_torch.utils.device import DeviceLike


@dataclass
class VocabShardedIndex:
    """Head-slot-sharded index for TP; hybrid when the index has a tail.

    ``head_rows[i]`` (d_local, N_pad) and ``head_scale[i]`` (N_pad / S,),
    int8 heads only, live on device i; ``tail_index[i]`` is the source
    index with its head stripped to empty tensors (the CSR postings, df and
    ``head_slot`` replicated on device i), or None for a full-vocab head."""

    head_rows: List[torch.Tensor]
    head_slot: List[torch.Tensor]
    head_scale: Optional[List[torch.Tensor]] = None
    tail_index: Optional[List[SparseIndex]] = None
    n_docs: int = 0
    n_docs_pad: int = 0
    vocab_size: int = 0
    d_local: int = 0
    n_shards: int = 1

    def per_device_bytes(self) -> dict:
        """Device 0's bytes as materialised: the head slice (and its scale
        slice), the replicated tail tensors, the replicated slot table."""
        def nbytes(t):
            return 0 if t is None else t.numel() * t.element_size()

        head = nbytes(self.head_rows[0])
        if self.head_scale is not None:
            head += nbytes(self.head_scale[0])
        tail = 0
        if self.tail_index is not None:
            t = self.tail_index[0]
            tail = sum(nbytes(x) for x in (
                t.indptr, t.postings_doc, t.postings_w, t.postings_tf,
                t.head_slot, t.head_rows, t.head_scale, t.stats.df,
                t.stats.idf, t.stats.doc_len, t.stats.avgdl))
        repl = nbytes(self.head_slot[0])
        return {"head_shard_bytes": head, "replicated_tail_bytes": tail,
                "replicated_slot_bytes": repl,
                "total_per_device_bytes": head + tail + repl}


def _shard_shape(index: SparseIndex, n_shards: int) -> Tuple[int, int]:
    D, N = index.head_rows.shape
    return (_round_up(-(-D // n_shards), 8),
            _round_up(-(-N // n_shards), 128) * n_shards)


def vocab_shard_layout(index: SparseIndex, n_shards: int) -> dict:
    """Per-device bytes of ``vocab_shard_index(index, n_shards)`` without
    building the shards (capacity planning at shard counts the host cannot
    hold): the same shape arithmetic."""
    d_loc, n_pad = _shard_shape(index, n_shards)
    head = d_loc * n_pad * index.head_rows.element_size()
    if index.head_scale is not None:
        head += (n_pad // n_shards) * 4
    tail = 0
    if index.head_size < index.vocab_size:
        nnz = int(index.postings_doc.shape[0])
        V = int(index.head_slot.shape[0])
        # indptr + postings_doc (i32) + postings_w (f32) + df (f32) + the
        # head_slot copy inside the tail index
        tail = (V + 1) * 4 + nnz * 8 + V * 4 + V * 4
    repl = int(index.head_slot.shape[0]) * 4
    return {"n_shards": n_shards, "head_shard_bytes": int(head),
            "replicated_tail_bytes": int(tail),
            "replicated_slot_bytes": repl,
            "total_per_device_bytes": int(head + tail + repl)}


def _strip_head(index: SparseIndex) -> SparseIndex:
    """The tail scorer's view: CSR postings, df and head_slot; every other
    tensor empty, so that the replicated copy holds only what is read."""
    empty = index.postings_w.new_zeros(0)
    return dataclasses.replace(
        index, head_rows=index.head_rows.new_zeros((0, 0)), head_scale=None,
        postings_tf=empty,
        stats=IndexStats(df=index.stats.df, idf=empty, doc_len=empty,
                         avgdl=empty))


def vocab_shard_index(index: SparseIndex, n_shards: int,
                      devices: Optional[Sequence[DeviceLike]] = None
                      ) -> VocabShardedIndex:
    """Split a SparseIndex along the head-slot axis, slice i on
    ``devices[i]`` (default: the index's device).  D pads to 8·S rows and
    N to 128·S columns (padded slots score 0, padded docs are masked).  A
    tail-bearing index (``head_size < vocab_size``) gets the hybrid layout:
    a stripped tail index replicated on each device."""
    D, N = index.head_rows.shape
    d_loc, n_pad = _shard_shape(index, n_shards)
    devs = [torch.device(d) for d in devices] if devices else \
        [index.device] * n_shards
    rows = index.head_rows
    scale = index.head_scale
    if d_loc * n_shards != D or n_pad != N:
        rows = torch.nn.functional.pad(rows, (0, n_pad - N,
                                              0, d_loc * n_shards - D))
        if scale is not None:
            scale = torch.nn.functional.pad(scale, (0, n_pad - N))
    n_loc = n_pad // n_shards
    tail = _strip_head(index) if index.head_size < index.vocab_size else None
    return VocabShardedIndex(
        head_rows=[_copy(rows[i * d_loc:(i + 1) * d_loc], d)
                   for i, d in enumerate(devs)],
        head_slot=[_copy(index.head_slot, d) for d in devs],
        head_scale=(None if scale is None else
                    [_copy(scale[i * n_loc:(i + 1) * n_loc], d)
                     for i, d in enumerate(devs)]),
        tail_index=None if tail is None else [tail.to(d) for d in devs],
        n_docs=index.n_docs, n_docs_pad=n_pad, vocab_size=index.vocab_size,
        d_local=d_loc, n_shards=n_shards)


def _exact_tail(tail: SparseIndex, qids_c: torch.Tensor, qw: torch.Tensor,
                scores: torch.Tensor, lo: int, n_loc: int) -> torch.Tensor:
    """The overflow fallback: scatter the raw tail postings whose doc falls
    in [lo, lo + n_loc) into this device's slice, for the whole batch."""
    Q, T = qids_c.shape
    P = tail.tail_pmax
    q = qids_c.long()
    df = tail.stats.df[q].to(torch.int64)
    start = tail.indptr[q].long()
    is_tail = (tail.head_slot[q] < 0) & (qw > 0)
    offs = torch.arange(P, device=qw.device)
    pos = (start[..., None] + offs).clamp(0, tail.postings_doc.shape[0] - 1)
    mask = (offs < df[..., None]) & is_tail[..., None]
    d_all = tail.postings_doc[pos].long() - lo
    v_all = tail.postings_w[pos] * qw[..., None]
    ok = mask & (d_all >= 0) & (d_all < n_loc)
    qq = torch.arange(Q, device=qw.device)[:, None, None].expand(Q, T, P)
    flat = (qq * n_loc + torch.where(ok, d_all, 0)).reshape(-1)
    out = scores.reshape(-1).clone()
    out.index_add_(0, flat, torch.where(ok, v_all, 0.0).reshape(-1))
    return out.view_as(scores)


def vocab_tp_score_topk(mesh: Mesh, vindex: VocabShardedIndex,
                        qids: torch.Tensor, qw: torch.Tensor,
                        top_k: int = 10, axis: str = "model",
                        tail_budget: int = 2048
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score replicated queries against the vocab-sharded head: partial
    product per device -> ``psum_scatter`` over the doc axis -> [hybrid:
    the in-range tail] -> masked local top-k -> gather and merge on the
    mesh's first device.  Returns (vals (Q, k), doc rows (Q, k))."""
    devs = mesh.axis_devices(axis)
    S = vindex.n_shards
    if len(devs) != S:
        raise ValueError(f"{S} slices on a {axis} axis of {len(devs)}")
    n_loc = vindex.n_docs_pad // S
    d_loc = vindex.d_local
    Q, T = qids.shape
    k_local = min(top_k, n_loc)
    qids_c = qids.clamp(0, vindex.vocab_size - 1)

    parts, q_on = [], []
    for i, dev in enumerate(devs):
        q, w = _copy(qids_c, dev), _copy(qw, dev)
        q_on.append((q, w))
        local_slot = vindex.head_slot[i][q.long()].long() - i * d_loc
        # a tail term's slot is -1: below every device's range
        active = (w > 0) & (local_slot >= 0) & (local_slot < d_loc)
        W = torch.zeros((Q, d_loc), dtype=torch.float32, device=dev)
        W.scatter_add_(1, torch.where(active, local_slot, 0),
                       torch.where(active, w, 0.0))
        parts.append(head_product(W, vindex.head_rows[i]))
    # sum the partials AND split the doc axis: device i gets (Q, n_loc)
    scores = psum_scatter(parts, devs, dim=1, tiled=True)
    if vindex.head_scale is not None:
        scores = [s * hs[None, :] for s, hs in zip(scores, vindex.head_scale)]

    if vindex.tail_index is not None:
        tails = vindex.tail_index
        budget = min(max(tail_budget, 4 * tails[0].tail_pmax),
                     16 * tails[0].tail_pmax)
        packed = [tail_compact(t, q, w, budget)
                  for t, (q, w) in zip(tails, q_on)]
        out = []
        for i, ((docs, v_enc, overflow), t, (q, w)) in enumerate(
                zip(packed, tails, q_on)):
            # host branch on the flag (lax.cond in the JAX code): one bool
            if bool(overflow.any()):
                out.append(_exact_tail(t, q, w, scores[i], i * n_loc, n_loc))
                continue
            dloc = docs.long() - i * n_loc
            inr = (v_enc >= 0) & (dloc >= 0) & (dloc < n_loc)
            flat = (torch.arange(Q, device=dloc.device)[:, None] * n_loc
                    + torch.where(inr, dloc, 0)).reshape(-1)
            s = scores[i].reshape(-1).clone()
            s.index_add_(0, flat, torch.where(inr, v_enc, 0.0).reshape(-1))
            out.append(s.view(Q, n_loc))
        scores = out

    vals_l, rows_l = [], []
    for i, s in enumerate(scores):
        col = torch.arange(n_loc, device=s.device)[None, :] + i * n_loc
        s = torch.where(col < vindex.n_docs, s,
                        torch.full((), NEG_INF, device=s.device))
        v, r = fast_topk(s, k_local)
        vals_l.append(v)
        rows_l.append(torch.where(torch.isfinite(v), r + i * n_loc,
                                  torch.zeros_like(r)))
    vals_m = all_gather(vals_l, mesh.first).permute(1, 0, 2).reshape(
        Q, S * k_local)
    rows_m = all_gather(rows_l, mesh.first).permute(1, 0, 2).reshape(
        Q, S * k_local)
    # lax.top_k's order on the merged candidates: value desc, row asc
    vals, rows = sort_desc_by_value_then_index(vals_m, rows_m)
    k_eff = min(top_k, S * k_local)
    vals, rows = vals[:, :k_eff], rows[:, :k_eff]
    if k_eff < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k_eff), value=NEG_INF)
        rows = torch.nn.functional.pad(rows, (0, top_k - k_eff))
    return vals, rows


@dataclass
class VocabTpBM25Model:
    """Router-compatible wrapper over a vocab-TP index: the
    ``topk_tokens`` surface of ``SparseModel``."""

    vocab: object
    vindex: VocabShardedIndex
    docids: list
    mesh: Mesh
    lang: str = "en"
    max_query_terms: int = 64
    axis: str = "model"

    @classmethod
    def from_model(cls, model, mesh: Mesh, axis: str = "model"
                   ) -> "VocabTpBM25Model":
        devs = mesh.axis_devices(axis)
        return cls(vocab=model.vocab,
                   vindex=vocab_shard_index(model.index, len(devs), devs),
                   docids=list(model.docids), mesh=mesh, lang=model.lang,
                   max_query_terms=model.max_query_terms, axis=axis)

    def encode_query_tokens(self, token_lists):
        from tdr_torch.text.vocab import encode_queries

        qids, qw = encode_queries(token_lists, self.vocab, self.max_query_terms)
        return torch.from_numpy(qids), torch.from_numpy(qw)

    def topk_tokens_async(self, token_lists, k: int = 10, pad_to=None):
        n = len(token_lists)
        if pad_to is not None and n < pad_to:
            token_lists = list(token_lists) + [[]] * (pad_to - n)
        qids, qw = self.encode_query_tokens(token_lists)
        vals, rows = vocab_tp_score_topk(
            self.mesh, self.vindex, _copy(qids, self.mesh.first),
            _copy(qw, self.mesh.first), top_k=k, axis=self.axis)
        return vals, rows, n

    def topk_tokens(self, token_lists, k: int = 10, pad_to=None):
        vals, rows, n = self.topk_tokens_async(token_lists, k, pad_to)
        return vals.cpu().numpy()[:n], rows.cpu().numpy()[:n]

    def retrieve_tokens(self, token_lists, k: int = 10):
        vals, rows = self.topk_tokens(token_lists, k, pad_to=len(token_lists))
        return [[self.docids[r] for r, v in zip(qr, qv) if np.isfinite(v)]
                for qr, qv in zip(rows, vals)]
