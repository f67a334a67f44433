"""Fused dense flat-search top-k: the port of ``fused_flat_topk`` in
``tdr/ops/pallas_flat.py``.

Phase 1 is the CUDA kernel ``tdr_torch/csrc/fused_flat.cu`` (a persistent,
warp-specialised wgmma kernel fed by a TMA ring; f32 in 3xTF32): the
product of the queries with the (N, D) embeddings (bf16 or f32 with f32
accumulation, or int8 x int8 → int32 dequantized by the per-doc and
per-query scales), times ``alpha``, plus a per-doc bias (the padding mask,
and ``-‖d‖²`` for l2), reduced to the maximum of each group of 8 documents,
so the (Q, N) score matrix never reaches memory.  Phase 2 is torch code, as
the JAX code does it in XLA: top-k over the group maxima, an exact f32
rescore of the k·8 candidate documents against the *effective* query (the
query rounded to the storage dtype, or ``q8·qs`` for int8), a 2-key sort
(value descending, row ascending), the dead-slot clean-up and, for l2,
``-‖q‖²``.  The exactness argument is the one in
``tdr.ops.topk.topk_grouped``.

``fused_flat_blockmax`` launches the kernel for CUDA tensors and takes the
plain version, ``fused_flat_blockmax_plain``, only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdr_torch.ops import cuda_build
from tdr_torch.ops.precision import ieee_f32
from tdr_torch.ops.tf32 import tf32_split
from tdr_torch.ops.topk import fast_topk, sort_desc_by_value_then_index

NEG = -1e30          # finite -inf stand-in: survives 0*x math
SUB = 8              # documents per group
_LANES = 128         # the query pad (and the kernel's query tile)
_VMEM_STEP_BUDGET = 5 * 1024 * 1024
_DTYPES = (torch.bfloat16, torch.float32, torch.int8)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pick_block(n: int, qp: int, d: int, esize: int) -> int:
    """The JAX kernel's block rule, kept so the engine gate is the same."""
    for b in (8192, 4096, 2048, 1024, 512, 256, 128):
        if n % b or b % (8 * SUB):
            continue
        if b * (qp * 4 + d * esize) <= _VMEM_STEP_BUDGET:
            return b
    return 0


def fused_flat_available(embeddings: torch.Tensor, top_k: int = 10,
                         sub: int = SUB) -> bool:
    """Shape gate of ``tdr.ops.pallas_flat.fused_flat_available``: D a
    multiple of 128, N a multiple of 64 and at least 8192, bf16/f32/int8
    storage.  The kernel groups ``SUB`` = 8 rows, so any other ``sub``
    fails the gate.  No environment variable takes part."""
    if sub != SUB:
        return False
    n, d = embeddings.shape
    if d % _LANES or n % (8 * SUB) or n < 8192:
        return False
    if embeddings.dtype not in _DTYPES:
        return False
    return n // SUB >= top_k and _pick_block(
        n, _LANES, d, embeddings.element_size()) > 0


def quantize_queries_int8(q: torch.Tensor):
    """Symmetric per-row int8 query quantization: (q8 (Q, D) int8, scale
    (Q, 1) f32) with q ≈ q8 · scale.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    qf = q.float()
    qmax = qf.abs().amax(dim=1, keepdim=True)
    qs = qmax.clamp_min(1e-30) / 127.0
    return torch.round(qf / qs).to(torch.int8), qs


@ieee_f32()
def fused_flat_blockmax_plain(q: torch.Tensor, emb: torch.Tensor,
                              bias: torch.Tensor, alpha: float,
                              dscale: Optional[torch.Tensor] = None,
                              qscale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of the kernel → (Qp, N/8) f32.  bf16/f32: the product
    of the upcast operands in f32.  int8: the integer product (in f64, where
    every partial sum of int8 products is exact), then ``acc · dscale[n] ·
    qscale[q]`` in f32 in that order.  Then ``alpha · s + bias`` and the
    maximum over each group of 8 documents."""
    if emb.dtype == torch.int8:
        acc = (q.double() @ emb.double().T).float()
        s = acc * dscale[None, :] * qscale[:, None]
    else:
        s = q.float() @ emb.float().T
    s = alpha * s + bias[None, :]
    return s.view(s.shape[0], -1, SUB).amax(dim=-1)


def fused_flat_blockmax(q: torch.Tensor, emb: torch.Tensor,
                        bias: torch.Tensor, alpha: float,
                        dscale: Optional[torch.Tensor] = None,
                        qscale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Group-of-8 maxima of ``alpha · (q · embᵀ) + bias`` (int8: with the
    scales), (Qp, N/8) f32: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not emb.is_cuda:
        return fused_flat_blockmax_plain(q, emb, bias, alpha, dscale, qscale)
    Qp, D = q.shape
    N, D2 = emb.shape
    if emb.dtype not in _DTYPES:
        raise ValueError(f"fused_flat: embeddings dtype {emb.dtype} not supported")
    is_int8 = emb.dtype == torch.int8
    if q.dtype != emb.dtype or bias.dtype != torch.float32:
        raise ValueError("fused_flat: q must have the embeddings' dtype and "
                         "bias f32")
    tensors = [("q", q), ("emb", emb), ("bias", bias)]
    if is_int8:
        if dscale is None or qscale is None:
            raise ValueError("fused_flat: int8 needs dscale and qscale")
        if (dscale.dtype != torch.float32 or qscale.dtype != torch.float32
                or dscale.numel() != N or qscale.numel() != Qp):
            raise ValueError("fused_flat: dscale (N,) and qscale (Qp,) f32")
        tensors += [("dscale", dscale), ("qscale", qscale)]
    if any(t.device != emb.device for _, t in tensors):
        raise ValueError("fused_flat: all operands must share one device")
    if D2 != D or tuple(bias.shape) != (N,):
        raise ValueError(f"fused_flat: shapes q {tuple(q.shape)}, emb "
                         f"{tuple(emb.shape)}, bias {tuple(bias.shape)}")
    if Qp % _LANES or N % 64 or (D * emb.element_size()) % 64:
        raise ValueError(f"fused_flat: needs Qp % 128 == 0, N % 64 == 0 and "
                         f"rows of a multiple of 64 bytes (got Qp={Qp}, N={N}, "
                         f"D={D}, {emb.dtype})")
    for name, t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_flat: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty((Qp, N // SUB), dtype=torch.float32, device=emb.device)
    name, symbol, lhs, scales = "fused_flat", "tdr_fused_flat_bf16", q, ()
    if is_int8:
        symbol = "tdr_fused_flat_int8"
        scales = (dscale.data_ptr(), qscale.data_ptr())
    elif emb.dtype != torch.bfloat16:
        # the B operand of the 3xTF32 products: big rows, then small rows
        name, symbol = "fused_flat_f32", "tdr_fused_flat_f32"
        lhs = torch.cat(tf32_split(q))
    cuda_build.launch(name, symbol, emb.device, lhs.data_ptr(), emb.data_ptr(),
                      bias.data_ptr(), *scales, out.data_ptr(), Qp, D, N,
                      alpha)
    return out


def fused_flat_inputs(embeddings: torch.Tensor, q: torch.Tensor,
                      metric: str = "ip", n_docs: int = 0,
                      doc_sq: Optional[torch.Tensor] = None,
                      doc_scale: Optional[torch.Tensor] = None,
                      n_valid: Optional[int] = None):
    """Phase 1's operands: (args for ``fused_flat_blockmax``, the effective
    query (Q, D) f32 that phase 2 rescores with, the per-doc bias (N,) f32).
    The queries are padded to a multiple of 128 rows; the bias holds the
    padding mask (-1e30 past ``n_valid``, else ``n_docs``) and, for l2,
    ``-‖d‖²``."""
    N, D = embeddings.shape
    Q = q.shape[0]
    dev = embeddings.device
    Qp = _round_up(max(Q, 1), _LANES)
    alpha = 2.0 if metric == "l2" else 1.0
    limit = n_docs if n_valid is None else n_valid
    valid = torch.arange(N, device=dev) < limit
    neg = torch.full((), NEG, device=dev)
    if metric == "l2":
        dsq = torch.nan_to_num(doc_sq.float(), posinf=-NEG)
        bias = torch.where(valid, -dsq, neg)
    else:
        bias = torch.where(valid, torch.zeros((), device=dev), neg)
    bias = bias.float().contiguous()
    qpad = torch.zeros((Qp, D), dtype=torch.float32, device=dev)
    qpad[:Q] = q.float()
    if embeddings.dtype == torch.int8:
        q8, qs = quantize_queries_int8(qpad)
        # the phase-2 rescore uses the query the kernel scored with, so group
        # selection and the final ranking agree to the f32-accumulation scale
        q_eff = q8[:Q].float() * qs[:Q]
        args = (q8, embeddings, bias, alpha, doc_scale.float().contiguous(),
                qs[:, 0].contiguous())
    else:
        qk = qpad.to(embeddings.dtype)
        q_eff = qk[:Q].float()
        args = (qk, embeddings, bias, alpha)
    return args, q_eff, bias


def fused_flat_topk(embeddings: torch.Tensor, q: torch.Tensor,
                    top_k: int = 10, metric: str = "ip", n_docs: int = 0,
                    doc_sq: Optional[torch.Tensor] = None,
                    doc_scale: Optional[torch.Tensor] = None,
                    n_valid: Optional[int] = None, sub: int = SUB,
                    interpret: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact flat top-k with fused block scoring: (vals (Q, top_k) f32, rows
    (Q, top_k) int64), the semantics of ``flat_search``: "ip" vals are inner
    products, "l2" vals are true ``-‖q-d‖²``; padding and out-of-range slots
    are (-inf, 0).  ``n_valid`` overrides ``n_docs``.  ``sub`` must be
    ``SUB`` (the kernel's group of 8 rows); ``interpret`` is accepted for
    ``tdr``'s signature and ignored (CPU tensors take the plain version)."""
    if sub != SUB:
        raise ValueError(f"sub={sub}: the kernel groups {SUB} rows")
    N = embeddings.shape[0]
    Q = q.shape[0]
    dev = embeddings.device
    args, q_eff, bias = fused_flat_inputs(embeddings, q, metric, n_docs,
                                          doc_sq, doc_scale, n_valid)
    alpha = args[3]
    gmax = fused_flat_blockmax(*args)[:Q]                    # (Q, N/8)

    # ---- phase 2: group select + exact rescore -------------------------
    k_g = min(top_k, N // SUB)
    _, gsel = fast_topk(gmax, k_g)
    cols = (gsel[:, :, None] * SUB
            + torch.arange(SUB, device=dev)).reshape(Q, k_g * SUB)
    cand = embeddings[cols].float()                          # (Q, C, D)
    if embeddings.dtype == torch.int8:
        cand = cand * doc_scale.float()[cols][..., None]
    # bmm in the pin, not K2's elementwise form: at the dense pass (C x D =
    # 80 x 384 a query) the product and sum cost the device more than the
    # pin costs the host
    with ieee_f32():
        dots = torch.bmm(cand, q_eff[:, :, None])[..., 0]
    scores = alpha * dots + bias[cols]
    vals, rows = sort_desc_by_value_then_index(scores, cols)
    k_eff = min(top_k, k_g * SUB)
    vals, rows = vals[:, :k_eff], rows[:, :k_eff]
    dead = vals <= NEG / 2
    vals = torch.where(dead, torch.full_like(vals, float("-inf")), vals)
    rows = torch.where(dead, torch.zeros_like(rows), rows)
    if metric == "l2":
        q_sq = (q.float() ** 2).sum(dim=1, keepdim=True)
        vals = torch.where(torch.isfinite(vals), vals - q_sq, vals)
    if k_eff < top_k:
        vals = torch.nn.functional.pad(vals, (0, top_k - k_eff),
                                       value=float("-inf"))
        rows = torch.nn.functional.pad(rows, (0, top_k - k_eff))
    return vals, rows
