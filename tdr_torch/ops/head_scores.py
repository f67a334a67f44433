"""Dense head-row score accumulation: the port of ``head_scores_pallas`` in
``tdr/ops/pallas_score.py``.

``scores[q, :] = Σ_t qw[q, t] · head_rows[slot[q, t], :]`` over at most
``max_head_terms`` active head terms per query, compacted head-first by a
stable sort so the sum runs in the JAX kernel's order; queries with more
active head terms are re-scored by the full-head product
(``tdr_torch.ops.score._head_scores_matmul``).  The accumulation is the CUDA
kernel ``tdr_torch/csrc/head_scores.cu``; ``head_scores_rows`` takes the
plain version, ``head_scores_rows_plain``, only for CPU tensors.  The two
agree bit for bit (each step rounds the product, then the sum).

As in ``tdr``, nothing routes a query here: this is an entry point of its
own beside the router's head engines.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tdr_torch.index.build import SparseIndex
from tdr_torch.ops import cuda_build
from tdr_torch.ops.score import _head_scores_matmul

MAX_HEAD_N = 1_500_000           # tdr's MAX_PALLAS_N: the doc-axis limit
DEFAULT_MAX_HEAD_TERMS = 16
_MAX_KERNEL_TERMS = 64           # the kernel's shared-memory term table


def _prep_terms(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact head terms to the front (stable on ~active): (slots (Q, T)
    int32, weights (Q, T) f32, n_active (Q,) int32)."""
    qids = qids.clamp(0, index.vocab_size - 1).long()
    slot = index.head_slot[qids].long()
    active = (slot >= 0) & (qw > 0)
    order = torch.argsort((~active).to(torch.int32), dim=1, stable=True)
    slot_c = slot.clamp_min(0).gather(1, order).to(torch.int32)
    qw_c = torch.where(active, qw, torch.zeros_like(qw)).gather(1, order)
    return slot_c, qw_c.float(), active.sum(dim=1).to(torch.int32)


def head_scores_rows_plain(rows: torch.Tensor, slots: torch.Tensor,
                           qw: torch.Tensor, n_active: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of the kernel → (Q, N) f32: term t of query q adds
    ``qw[q, t] · rows[slots[q, t]]`` while ``t < n_active[q]``."""
    Q, T = slots.shape
    acc = torch.zeros((Q, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for t in range(T):
        term = qw[:, t:t + 1] * rows[slots[:, t].long()].float()
        acc = torch.where((t < n_active)[:, None], acc + term, acc)
    return acc


def head_scores_rows(rows: torch.Tensor, slots: torch.Tensor,
                     qw: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 sums of the weighted head rows: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not rows.is_cuda:
        return head_scores_rows_plain(rows, slots, qw, n_active)
    D, N = rows.shape
    Q, T = slots.shape
    if rows.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"head_scores: rows dtype {rows.dtype} not supported")
    if (slots.dtype != torch.int32 or n_active.dtype != torch.int32
            or qw.dtype != torch.float32):
        raise ValueError("head_scores: slots and n_active int32, qw f32")
    if tuple(qw.shape) != (Q, T) or tuple(n_active.shape) != (Q,):
        raise ValueError(f"head_scores: shapes slots {tuple(slots.shape)}, "
                         f"qw {tuple(qw.shape)}, n_active "
                         f"{tuple(n_active.shape)}")
    if N % 4 or T > _MAX_KERNEL_TERMS or Q > 65535:
        raise ValueError(f"head_scores: needs N % 4 == 0, T <= "
                         f"{_MAX_KERNEL_TERMS}, Q <= 65535 (got N={N}, T={T}, "
                         f"Q={Q})")
    for name, t in (("rows", rows), ("slots", slots), ("qw", qw),
                    ("n_active", n_active)):
        if t.device != rows.device:
            raise ValueError("head_scores: all operands must share one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"head_scores: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty((Q, N), dtype=torch.float32, device=rows.device)
    if Q == 0:
        return out
    symbol = ("tdr_head_scores_bf16" if rows.dtype == torch.bfloat16
              else "tdr_head_scores_f32")
    cuda_build.launch("head_scores", symbol, rows.device, rows.data_ptr(),
                      slots.data_ptr(), qw.data_ptr(), n_active.data_ptr(),
                      out.data_ptr(), Q, T, N)
    return out


def head_scores(index: SparseIndex, qids: torch.Tensor, qw: torch.Tensor,
                max_head_terms: int = DEFAULT_MAX_HEAD_TERMS,
                interpret: bool = False) -> torch.Tensor:
    """(Q, N_pad) f32 head scores from at most ``max_head_terms`` active head
    rows per query; queries with more are re-scored by the full-head
    product.  ``interpret`` is accepted for ``tdr``'s signature and ignored
    (CPU tensors take the plain version)."""
    if index.head_rows.dtype == torch.int8:
        raise NotImplementedError(
            "head_scores does not implement int8 dequantization (as "
            "tdr's head_scores_pallas); the full-head product scores "
            "quantized heads")
    slots, qw_c, n_active = _prep_terms(index, qids, qw)
    TH = min(max_head_terms, qids.shape[1])
    overflow = n_active > TH
    out = head_scores_rows(index.head_rows, slots[:, :TH].contiguous(),
                           qw_c[:, :TH].contiguous(), n_active)
    # a torch branch on the flag (lax.cond in tdr): reading it back forces
    # one device sync per call
    if bool(overflow.any()):
        ref = _head_scores_matmul(
            index, qids.clamp(0, index.vocab_size - 1), qw)
        out = torch.where(overflow[:, None], ref, out)
    return out


def head_scores_available(index: SparseIndex) -> bool:
    """``tdr.ops.pallas_score.pallas_head_available``: a CUDA head of at most
    1.5M padded documents, not int8."""
    return (index.head_rows.is_cuda
            and index.n_docs_pad <= MAX_HEAD_N
            and index.head_rows.dtype != torch.int8)
