"""Masked softmax attention of (B, H, L, Dh) heads, as flax's
``dot_product_attention`` computes it in the compute dtype, forward and
backward.

The *query* is divided by ``sqrt(head_dim)`` rounded to the dtype; the
scores are masked with ``finfo(dtype).min`` where the query or the key is
padding (``attention_mask``; not ``-inf``: a padded query row, whose keys
are all masked, then gets a uniform softmax instead of NaN, and NaN would
survive the encoder's mean pooling); the softmax is taken in the dtype.
The output comes in the (B, L, H * Dh) layout of the output projection's
input.

``attend`` runs it on bf16 CUDA heads as two hand-written kernels
(``tdr_torch/csrc/attention.cu``) behind an autograd ``Function``, and on
the CPU, and in f32 (the IEEE reference precision,
``ops.precision.ieee_f32``) on any device, as the plain ops,
``attend_plain``; the closed-form backward, ``attend_backward_plain``, is
the backward kernel's arithmetic.  The forward kernel takes q, k and v as
(B, H, L, Dh) views with any shared strides whose rows are 16-byte aligned
(the projections' (B, L, H * Dh) outputs, uncopied) and the (B, L)
validity of each position, and returns the output with each row's f32
(max, sum) of the softmax; the backward kernel takes them back with dO
(B, L, H * Dh) and returns dq, dk and dv as (B, H, L, Dh) views of (B, L,
H * Dh) tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tdr_torch.ops import cuda_build
from tdr_torch.ops.precision import compute_dtype
from tdr_torch.utils.trace import count

MAX_L = 512
HEAD_DIMS = (16, 32, 64)
_TILE = 128          # rows a block's tile; longer rows need the dq scratch


def attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """flax ``make_attention_mask(mask, mask)``: padded query rows masked
    too; (B, 1, L, L) bool."""
    valid = mask > 0
    return valid[:, None, :, None] & valid[:, None, None, :]


def _query_scale(head_dim: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(math.sqrt(head_dim)).to(dtype)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The forward in plain torch ops, (B, H, L, Dh) heads → (B, L, H * Dh):
    the CPU and f32 path, and what the forward kernel computes.  ``valid``
    (B, L) bool."""
    B, H, L, Dh = q.shape
    q = q / _query_scale(Dh, dtype)
    w = q @ k.transpose(-1, -2)                             # (B, H, L, L)
    w = w.masked_fill(~attention_mask(valid), torch.finfo(dtype).min)
    w = torch.softmax(w, dim=-1)
    return (w @ v).transpose(1, 2).reshape(B, L, H * Dh)


def attend_backward_plain(dout: torch.Tensor, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The gradients of ``attend_plain`` in closed form, (dq, dk, dv) as
    (B, H, L, Dh) in q's dtype from dO (B, L, H * Dh), with the backward
    kernel's arithmetic: P recomputed as the forward makes it; ``dP = dO
    vᵀ``, ``dv = Pᵀ dO``; ``dS = P (dP - Σⱼ P dP)`` in f32 from the
    rounded P and dP (torch's softmax backward), 0 wherever the mask is
    false (the masked fill's backward: a padded query row's every entry);
    ``dq = (dS k) / scale``, ``dk = dSᵀ q_s``, each product rounded to q's
    dtype."""
    B, H, L, Dh = q.shape
    dtype = q.dtype
    f = compute_dtype(q)
    scale = _query_scale(Dh, dtype)
    mask = attention_mask(valid)
    qs = q / scale
    s = (qs @ k.transpose(-1, -2)).masked_fill(~mask, torch.finfo(dtype).min)
    p = torch.softmax(s, dim=-1)
    do = dout.view(B, L, H, Dh).transpose(1, 2)
    dp = do @ v.transpose(-1, -2)
    pf, dpf = p.to(f), dp.to(f)
    ds = (pf * (dpf - (pf * dpf).sum(dim=-1, keepdim=True))).to(dtype)
    ds = ds.masked_fill(~mask, 0)
    return ((ds @ k) / scale, ds.transpose(-1, -2) @ qs,
            p.transpose(-1, -2) @ do)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raises ``ValueError`` unless the kernels take ``q``, ``k``, ``v``:
    bf16 (B, H, L, Dh) with Dh in ``HEAD_DIMS`` and 1 <= L <= ``MAX_L``,
    sharing their strides, the last one 1 and the others multiples of 8 (16
    bytes), 16-byte aligned; and ``valid``, a contiguous (B, L) bool; all on
    one device.  Returns (B, H, L, Dh)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"attention kernel: {name} is {t.dim()}-D "
                             f"{t.dtype}, not 4-D bfloat16")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    B, H, L, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"attention kernel: head width {Dh}; takes "
                         f"{HEAD_DIMS}")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"attention kernel: {L} positions; takes 1 to "
                         f"{MAX_L}")
    if B * H >= 2 ** 31:
        raise ValueError(f"attention kernel: {B * H} heads; at most "
                         f"2**31 - 1")
    st = q.stride()
    if k.stride() != st or v.stride() != st:
        raise ValueError(f"attention kernel: strides q {st}, k "
                         f"{k.stride()}, v {v.stride()} differ")
    if st[3] != 1 or any(s % 8 or s < 0 for s in st[:3]):
        raise ValueError(f"attention kernel: strides {st}; the last must be "
                         f"1, the others multiples of 8")
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, L) \
            or not valid.is_contiguous():
        raise ValueError(f"attention kernel: valid is {tuple(valid.shape)} "
                         f"{valid.dtype}, not a contiguous ({B}, {L}) bool")
    for t in (q, k, v, valid):
        if t.device != q.device:
            raise ValueError("attention kernel: operands on "
                             f"{q.device} and {t.device}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("attention kernel: q, k and v must be 16-byte "
                             "aligned")
    return B, H, L, Dh


def scale_of(head_dim: int) -> float:
    """bf16(sqrt(head_dim)), the divisor of the queries, as a float."""
    return float(torch.tensor(math.sqrt(head_dim)).to(torch.bfloat16))


def _need_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"attention kernel: a {x.device} tensor; CUDA "
                         f"tensors only")


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """A (B, L, H * Dh) tensor as its (B, H, L, Dh) view."""
    B, L, _ = x.shape
    return x.view(B, L, H, -1).transpose(1, 2)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output (B, L, H * Dh) bf16 and the statistics (B, H, L, 2) f32."""
    _need_cuda(q)
    B, H, L, Dh = check_args(q, k, v, valid)
    out = torch.empty((B, L, H * Dh), dtype=torch.bfloat16, device=q.device)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=q.device)
    if B == 0 or H == 0:
        return out, stats
    sb, sh, sl, _ = q.stride()
    cuda_build.launch("attention_fwd", "tdr_attention_fwd", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, sl,
                      valid.data_ptr(), out.data_ptr(), stats.data_ptr(), B,
                      H, L, Dh, scale_of(Dh))
    return out, stats


def attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, valid: torch.Tensor, stats: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each (B, H, L, Dh) bf16, from dO (B, L, H * Dh) bf16,
    contiguous, and the forward's operands and statistics."""
    _need_cuda(q)
    B, H, L, Dh = check_args(q, k, v, valid)
    if (dout.dtype != torch.bfloat16 or tuple(dout.shape) != (B, L, H * Dh)
            or not dout.is_contiguous() or dout.data_ptr() % 16
            or dout.device != q.device):
        raise ValueError(f"attention kernel: dO is {tuple(dout.shape)} "
                         f"{dout.dtype}; a contiguous, 16-byte aligned "
                         f"({B}, {L}, {H * Dh}) bfloat16 on q's device")
    if (stats.dtype != torch.float32 or tuple(stats.shape) != (B, H, L, 2)
            or not stats.is_contiguous() or stats.device != q.device):
        raise ValueError(f"attention kernel: stats {tuple(stats.shape)} "
                         f"{stats.dtype}, not the forward's")
    grads = [torch.empty((B, L, H * Dh), dtype=torch.bfloat16,
                         device=q.device) for _ in range(3)]
    if B == 0 or H == 0:
        return tuple(_heads(x, H) for x in grads)
    # dS k summed over the key tiles in f32, for rows longer than a tile
    part = (torch.empty((B, H, L, Dh), dtype=torch.float32, device=q.device)
            if L > _TILE else None)
    sb, sh, sl, _ = q.stride()
    cuda_build.launch("attention_bwd", "tdr_attention_bwd", q.device,
                      dout.data_ptr(), q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), sb, sh, sl, valid.data_ptr(),
                      stats.data_ptr(), *(x.data_ptr() for x in grads),
                      None if part is None else part.data_ptr(), B, H, L,
                      Dh, scale_of(Dh))
    return tuple(_heads(x, H) for x in grads)


class _AttentionKernel(torch.autograd.Function):
    """``attend_plain`` on bf16 heads as the two kernels: the forward saves
    q, k, v and each row's softmax max and sum, not P; the backward
    recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, valid):
        out, stats = attention_fwd(q, k, v, valid)
        ctx.save_for_backward(q, k, v, valid, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, stats = ctx.saved_tensors
        dq, dk, dv = attention_bwd(dout.contiguous(), q, k, v, valid, stats)
        return dq, dk, dv, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Masked softmax attention of (B, H, L, Dh) heads in ``dtype`` →
    (B, L, H * Dh), before the output projection; ``valid`` (B, L) bool
    marks the real positions.  On CUDA in bf16 the kernels (or
    ``check_args`` raises); on the CPU, and in f32 on any device,
    ``attend_plain``.  While a profiler records, counts the query rows
    (B x H x L) under ``encoder.attn_rows``, and those the kernels took
    under ``encoder.attn_rows_kernel``."""
    rows = math.prod(q.shape[:-1])
    count("encoder.attn_rows", rows)
    if not q.is_cuda or dtype != torch.bfloat16:
        return attend_plain(q, k, v, valid, dtype)
    out = _AttentionKernel.apply(q, k, v, valid)
    count("encoder.attn_rows_kernel", rows)
    return out
