"""Tail-posting compaction: the port of ``tdr/ops/pallas_tail.py``.

For each query, the tail terms (active, not in the head) are compacted to
at most ``MT = min(16, T)`` per query, in term order; their segment lengths
are scanned into compacted offsets ``min(Σ_{s<t} len_s, budget)``; and each
term's contiguous CSR segment lands in a row of width W at its offset, a
later term overwriting an earlier one where clamped offsets overlap.  Dead
lanes hold ``(n_docs_pad, -1.0)``, the encoding
``score._fused_topk_core``'s doc-sort consumes.  A query overflows with
more than MT tail terms or more than ``budget`` postings in its kept ones.

``tail_compact`` does all of it in one launch of the CUDA kernel
``tdr_torch/csrc/tail_compact.cu`` for CUDA tensors, and takes the plain
version, ``tail_compact_plain`` (the stable sort and scan of
``tail_segments``, then the segment copy of ``tail_compact_rows_plain``),
only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops import cuda_build

DEFAULT_MAX_TAIL_TERMS = 16
_MAX_KERNEL_TERMS = 32     # MT is kept by one warp
_ALIGN = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dma_window(tail_pmax: int) -> int:
    """The JAX kernel's aligned segment window (kept for the row width)."""
    return _round_up(tail_pmax + _ALIGN - 1, _ALIGN)


def row_width(budget: int, tail_pmax: int) -> int:
    """W of the JAX kernel, so both outputs compare lane for lane."""
    return _round_up(max(budget + tail_pmax, dma_window(tail_pmax)), _ALIGN)


def tail_compact_rows_plain(
    postings_doc: torch.Tensor, postings_w: torch.Tensor,
    starts: torch.Tensor, lens: torch.Tensor, offs: torch.Tensor,
    qw: torch.Tensor, width: int, sentinel: int, tail_pmax: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: terms in order, later terms
    overwriting earlier ones where clamped offsets overlap."""
    Q, MT = starts.shape
    dev = postings_doc.device
    docs = torch.full((Q, width), sentinel, dtype=torch.int32, device=dev)
    vals = torch.full((Q, width), -1.0, dtype=torch.float32, device=dev)
    P = max(int(tail_pmax), 1)
    ar = torch.arange(P, device=dev)
    last = postings_doc.shape[0] - 1
    for t in range(MT):
        lane = offs[:, t:t + 1].long() + ar                   # (Q, P)
        live = (ar < lens[:, t:t + 1]) & (lane < width)
        lane = lane.clamp(max=width - 1)
        src = (starts[:, t:t + 1].long() + ar).clamp(0, last)
        new_d = torch.where(live, postings_doc[src], docs.gather(1, lane))
        new_v = torch.where(live, postings_w[src] * qw[:, t:t + 1],
                            vals.gather(1, lane))
        docs.scatter_(1, lane, new_d)
        vals.scatter_(1, lane, new_v)
    return docs, vals


def tail_segments(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                  budget: int, max_tail_terms: int = DEFAULT_MAX_TAIL_TERMS):
    """Level-1 term compaction and the offset scan of the plain version:
    (starts, lens, offs, qw_c) each (Q, MT), and overflow (Q,) for queries
    with more than MT tail terms or more than ``budget`` slots."""
    Q, T = qids.shape
    qids = qids.clamp(0, index.vocab_size - 1).long()
    slot = index.head_slot[qids]
    df = index.stats.df[qids].to(torch.int32)
    start = index.indptr[qids]
    is_tail = (slot < 0) & (qw > 0)

    MT = min(max_tail_terms, T)
    order = torch.argsort((~is_tail).to(torch.int32), dim=1, stable=True)[:, :MT]
    start_c = start.gather(1, order)
    df_c = df.gather(1, order)
    qw_c = qw.gather(1, order).float()
    tail_c = is_tail.gather(1, order)
    overflow = is_tail.sum(dim=1) > MT

    zero = torch.zeros_like(df_c)
    lens = torch.where(tail_c, df_c, zero)
    starts = torch.where(tail_c, start_c, zero)
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)
    overflow = overflow | (cum[:, -1] > budget)
    offs = torch.clamp(cum - lens, max=budget).to(torch.int32)
    return (starts.contiguous(), lens.contiguous(), offs.contiguous(),
            qw_c.contiguous(), overflow)


def tail_compact_plain(index: SparseIndex, qids: torch.Tensor,
                       qw: torch.Tensor, budget: int,
                       max_tail_terms: int = DEFAULT_MAX_TAIL_TERMS
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``tail_segments`` then
    ``tail_compact_rows_plain``."""
    starts, lens, offs, qw_c, overflow = tail_segments(
        index, qids, qw, budget, max_tail_terms)
    width = row_width(budget, index.tail_pmax)
    docs, vals = tail_compact_rows_plain(
        index.postings_doc, index.postings_w, starts, lens, offs, qw_c,
        width, index.n_docs_pad, index.tail_pmax)
    return docs, vals, overflow


def tail_compact(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                 budget: int, max_tail_terms: int = DEFAULT_MAX_TAIL_TERMS,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compacted tail slots: (docs (Q, W) int32, vals (Q, W) f32, overflow
    (Q,) bool) with W = ``row_width(budget, tail_pmax)``; vals == -1 marks
    dead lanes (``tdr.ops.pallas_tail.tail_compact_pallas``'s contract).  On
    CUDA tensors one launch of the kernel does it all, term compaction
    included; on CPU tensors the plain version runs.  ``interpret`` is
    accepted for ``tdr``'s signature and ignored."""
    if not qids.is_cuda:
        return tail_compact_plain(index, qids, qw, budget, max_tail_terms)
    Q, T = qids.shape
    MT = min(max_tail_terms, T)
    dev = qids.device
    tensors = (("qids", qids, torch.int32), ("qw", qw, torch.float32),
               ("head_slot", index.head_slot, torch.int32),
               ("df", index.stats.df, torch.float32),
               ("indptr", index.indptr, torch.int32),
               ("postings_doc", index.postings_doc, torch.int32),
               ("postings_w", index.postings_w, torch.float32))
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"tail_compact: {name} must be a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if tuple(qw.shape) != (Q, T) or MT > _MAX_KERNEL_TERMS:
        raise ValueError(f"tail_compact: qids {tuple(qids.shape)}, qw "
                         f"{tuple(qw.shape)}, max_tail_terms {max_tail_terms} "
                         f"(the kernel keeps at most {_MAX_KERNEL_TERMS})")
    width = row_width(budget, index.tail_pmax)
    docs = torch.empty((Q, width), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, width), dtype=torch.float32, device=dev)
    overflow = torch.empty(Q, dtype=torch.bool, device=dev)
    cuda_build.launch(
        "tail_compact", "tdr_tail_compact_fused", dev,
        qids.data_ptr(), qw.data_ptr(), index.head_slot.data_ptr(),
        index.stats.df.data_ptr(), index.indptr.data_ptr(),
        index.postings_doc.data_ptr(), index.postings_w.data_ptr(),
        docs.data_ptr(), vals.data_ptr(), overflow.data_ptr(), Q, T, MT,
        width, budget, index.vocab_size, max(int(index.tail_pmax), 1),
        index.postings_doc.numel(), index.n_docs_pad)
    return docs, vals, overflow
