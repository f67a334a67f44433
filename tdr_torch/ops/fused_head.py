"""Fused full-vocab-head top-k: the port of ``fused_head_topk`` in
``tdr/ops/pallas_flat.py``.

Phase 1 is the CUDA kernel ``tdr_torch/csrc/fused_head.cu``: the head
product with f32 accumulation plus a -1e30 pad bias, reduced to the maximum
of each group of 8 documents, so the (Q, N) score matrix never reaches
memory.  Before it, ``compact_active_rows`` lists on the device the head
slots some query of the batch uses (``rows``, ``n_active``) and gathers
their weight columns into ``Wc``, so the kernel streams only those rows
of the head (bf16 heads through ``wgmma`` in bf16, f32 heads in 3xTF32 on
the tensor cores).  Phase 2 is torch code, as the JAX code does it in XLA:
top-k over the group maxima, an exact rescore of the k·8 candidate
documents from the active terms (slot-summed, head-dtype-rounded weights
with a first-occurrence guard for terms sharing a slot), and a 2-key sort
(value descending, row ascending).  The exactness argument is the one in
``tdr.ops.topk.topk_grouped``.

``fused_head_blockmax`` launches the kernel for CUDA tensors and takes the
plain version, ``fused_head_blockmax_plain``, only for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tdr_torch.ops import cuda_build
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.ops.tf32 import tf32_split
from tdr_torch.ops.topk import fast_topk, sort_desc_by_value_then_index

NEG = -1e30          # finite -inf stand-in: survives 0*x math
SUB = 8              # documents per group
_LANES = 128
_Q_TILE = 128        # the kernel's query tile; W is padded to a multiple
_VMEM_STEP_BUDGET = 5 * 1024 * 1024
_RESCORE_ELEMS = 1 << 24   # head values gathered per rescore step


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_head_block(n: int, qp: int, d: int, esize: int, sub: int) -> int:
    """The JAX kernel's block rule, kept so the engine gate is the same."""
    for b in (2048, 1024, 512, 256, 128):
        if n % b or b % (8 * sub):
            continue
        if b * (d * esize + qp * 4) + d * qp * esize <= _VMEM_STEP_BUDGET:
            return b
    return 0


def fused_head_available(index, top_k: int = 10, sub: int = SUB) -> bool:
    """Shape gate of ``tdr.ops.pallas_flat.fused_head_available``: a
    full-vocab head (no tail to merge), bf16/f32 rows, aligned shapes and
    at least 65,536 documents.  The kernel groups ``SUB`` = 8 documents, so
    any other ``sub`` fails the gate.  No environment variable takes
    part."""
    if sub != SUB or index.head_size < index.vocab_size:
        return False
    d, n = index.head_rows.shape
    if index.head_rows.dtype not in (torch.bfloat16, torch.float32):
        return False
    if d % 8 or n % (8 * sub) or n < 65536 or n // sub < top_k:
        return False
    return _pick_head_block(n, _LANES, d, index.head_rows.element_size(),
                            sub) > 0


@ieee_f32()
def fused_head_blockmax_plain(Wc: torch.Tensor, head: torch.Tensor,
                              rows: torch.Tensor, n_active: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``Wc[:, :n] · head[rows[:n]]`` in f32
    (n = ``n_active``), + bias, max over groups of 8 documents → (Qp, N/8)
    f32.  Reads ``n_active`` on the host."""
    n = int(n_active)
    s = Wc[:, :n].float() @ head[rows[:n].long()].float() + bias[None, :]
    return s.view(s.shape[0], -1, SUB).amax(dim=-1)


def fused_head_blockmax(Wc: torch.Tensor, head: torch.Tensor,
                        rows: torch.Tensor, n_active: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Group-of-8 maxima of ``Wc[:, :n_active] · head[rows[:n_active]] +
    bias``, (Qp, N/8) f32: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  Both kernels stream only the ``n_active``
    listed rows and read ``n_active`` on the device; an f32 head runs the
    3xTF32 body, which takes ``Wc`` split by ``tf32_split``."""
    if not head.is_cuda:
        return fused_head_blockmax_plain(Wc, head, rows, n_active, bias)
    Qp, D = Wc.shape
    D2, N = head.shape
    if head.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_head: head dtype {head.dtype} not supported")
    if (Wc.dtype != head.dtype or bias.dtype != torch.float32
            or rows.dtype != torch.int32 or n_active.dtype != torch.int32):
        raise ValueError("fused_head: Wc must have the head's dtype, bias "
                         "f32, rows and n_active int32")
    tensors = (("Wc", Wc), ("head", head), ("rows", rows),
               ("n_active", n_active), ("bias", bias))
    if any(t.device != head.device for _, t in tensors):
        raise ValueError("fused_head: all operands must share one device")
    if (D2 != D or tuple(bias.shape) != (N,) or tuple(rows.shape) != (D,)
            or n_active.numel() != 1):
        raise ValueError(f"fused_head: shapes Wc {tuple(Wc.shape)}, head "
                         f"{tuple(head.shape)}, rows {tuple(rows.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if Qp % _Q_TILE or N % 128 or D % 8:
        raise ValueError(f"fused_head: needs Qp % 128 == 0, N % 128 == 0, "
                         f"D % 8 == 0 (got Qp={Qp}, N={N}, D={D})")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_head: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty((Qp, N // SUB), dtype=torch.float32, device=head.device)
    name, symbol, lhs = "fused_head", "tdr_fused_head_bf16", Wc
    if head.dtype != torch.bfloat16:
        # the B operand of the 3xTF32 products: big rows, then small rows
        name, symbol = "fused_head_f32", "tdr_fused_head_f32"
        lhs = torch.cat(tf32_split(Wc))
    cuda_build.launch(name, symbol, head.device, lhs.data_ptr(),
                      head.data_ptr(), rows.data_ptr(), n_active.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), Qp, D, N)
    return out


def query_weight_matrix(index, qids: torch.Tensor, qw: torch.Tensor):
    """Scatter the active terms' weights into W (Q, D) f32 over head slots;
    returns (W, slot (Q, T) int64, active (Q, T))."""
    Q, T = qids.shape
    D = index.head_rows.shape[0]
    slot = index.head_slot[qids.clamp(0, index.vocab_size - 1).long()].long()
    active = (slot >= 0) & (qw > 0)
    q_idx = torch.arange(Q, device=qids.device)[:, None].expand(Q, T)
    W = torch.zeros((Q, D), dtype=torch.float32, device=qids.device)
    W.index_put_((q_idx.reshape(-1), torch.where(active, slot, 0).reshape(-1)),
                 torch.where(active, qw, torch.zeros_like(qw)).reshape(-1),
                 accumulate=True)
    return W, slot, active


def compact_active_rows(W: torch.Tensor, slot: torch.Tensor,
                        active: torch.Tensor, Qp: int, dtype: torch.dtype):
    """The head slots the batch uses, on the device and without a host sync:
    ``rows`` (D,) int32 holds the slots that some active term maps to, first
    and ascending, then the others; ``n_active`` (1,) int32 counts the
    first; ``Wc`` (Qp, D) in ``dtype`` has column j = ``W[:, rows[j]]``, so
    its columns from ``n_active`` on are zero (no query weights an unused
    slot).  A cumsum places each slot; no ``nonzero`` or boolean index."""
    D = W.shape[1]
    dev = W.device
    used = torch.zeros(D, dtype=torch.int32, device=dev)
    used.index_add_(0, torch.where(active, slot, 0).reshape(-1),
                    active.reshape(-1).to(torch.int32))
    used = used > 0
    c_used = torch.cumsum(used, 0)
    n_active = c_used[-1:].to(torch.int32)
    pos = torch.where(used, c_used - 1,
                      n_active + torch.cumsum(~used, 0) - 1)
    rows = torch.empty(D, dtype=torch.int64, device=dev)
    rows.scatter_(0, pos, torch.arange(D, device=dev))
    Wc = torch.zeros((Qp, D), dtype=dtype, device=dev)
    Wc[:W.shape[0]] = W[:, rows].to(dtype)
    return rows.to(torch.int32), n_active, Wc


def fused_head_topk(index, qids: torch.Tensor, qw: torch.Tensor,
                    top_k: int = 10, n_valid: Optional[int] = None,
                    sub: int = SUB, interpret: bool = False, *,
                    blockmax: Callable = fused_head_blockmax,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact head-score top-k of a full-vocab-head index without the (Q, N)
    score matrix: (vals (Q, top_k) f32, rows (Q, top_k) int64), padded with
    (-inf, 0).  ``blockmax`` computes phase 1; a caller may pass
    ``fused_head_blockmax_plain`` to hold the kernel against its plain
    version through the whole function.  ``sub`` must be ``SUB`` (the
    kernel's group of 8 documents); ``interpret`` is accepted for ``tdr``'s
    signature and ignored (CPU tensors take the plain version)."""
    if sub != SUB:
        raise ValueError(f"sub={sub}: the kernel groups {SUB} documents")
    head = index.head_rows
    D, N = head.shape
    Q, T = qids.shape
    dev = head.device
    Qp = _round_up(max(Q, 1), _Q_TILE)
    ng = N // SUB

    W, slot, active = query_weight_matrix(index, qids, qw)
    rows_c, n_active, Wc = compact_active_rows(W, slot, active, Qp,
                                               head.dtype)
    limit = index.n_docs if n_valid is None else n_valid
    bias = torch.where(torch.arange(N, device=dev) < limit,
                       torch.zeros((), device=dev),
                       torch.full((), NEG, device=dev)).float()

    gmax = blockmax(Wc, head, rows_c, n_active, bias)[:Q]  # (Q, ng)
    k_g = min(top_k, ng)
    _, gsel = fast_topk(gmax, k_g)
    cols = (gsel[:, :, None] * SUB
            + torch.arange(SUB, device=dev)).reshape(Q, k_g * SUB)

    # exact rescore from the active terms: the effective weight is the
    # SLOT-summed, head-dtype-rounded value the kernel contracted with
    slot0 = torch.where(active, slot, 0)
    q_idx = torch.arange(Q, device=dev)[:, None].expand(Q, T)
    w_eff = W[q_idx, slot0].to(head.dtype).float()
    w_eff = torch.where(active, w_eff, torch.zeros_like(w_eff))
    # first-occurrence guard: terms sharing a slot contribute once
    if T > 1:
        tri = torch.ones((T, T), dtype=torch.bool, device=dev).tril(-1)
        eq_prior = ((slot[:, :, None] == slot[:, None, :]) & tri
                    & active[:, :, None] & active[:, None, :])
        w_eff = torch.where(eq_prior.any(dim=2), torch.zeros_like(w_eff), w_eff)
    # (Qc, T, C) gathered head values per step: at the widest callers
    # (T = 69 expanded terms, top_k = 1034, C = 8,272) a whole batch of 256
    # would gather 146 M values, so the queries go in chunks
    C = cols.shape[1]
    q_chunk = max(1, _RESCORE_ELEMS // max(T * C, 1))
    scores = torch.empty((Q, C), dtype=torch.float32, device=dev)
    # an elementwise product and a sum, not bmm: full f32 whatever the
    # caller's TF32 setting, and no process-wide pin on the hot path
    for q0 in range(0, Q, q_chunk):
        s0, c0 = slot0[q0:q0 + q_chunk], cols[q0:q0 + q_chunk]
        rows_cand = head[s0[:, :, None], c0[:, None, :]]       # (Qc, T, C)
        scores[q0:q0 + q_chunk] = (w_eff[q0:q0 + q_chunk, :, None]
                                   * rows_cand).sum(dim=1)
    scores = scores + bias[cols]
    vals, rows = sort_desc_by_value_then_index(scores, cols)
    k_eff = min(top_k, k_g * SUB)
    vals, rows = vals[:, :k_eff], rows[:, :k_eff]
    dead = vals <= NEG / 2
    vals = torch.where(dead, torch.full_like(vals, float("-inf")), vals)
    rows = torch.where(dead, torch.zeros_like(rows), rows)
    if k_eff < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k_eff),
                                       value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, top_k - k_eff))
    return vals, rows
