"""LayerNorm over the last axis as flax ``nn.LayerNorm(dtype=float32)``
computes it, forward and backward.

The statistics are taken in f32 (f64 stays f64) with flax's fast variance,
``E[x²] - E[x]²`` clamped at 0, epsilon ``EPS`` by default, and the output
is f32: ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.  The backward
drops the variance's term of dx where the clamp is active, as
``clamp_min``'s backward does.

``layer_norm`` runs it on a CUDA tensor as two hand-written kernels
(``tdr_torch/csrc/layer_norm.cu``) behind an autograd ``Function``, and on
a CPU tensor as the plain ops, ``layer_norm_plain``; the closed-form
backward, ``layer_norm_backward_plain``, is the backward kernel's
arithmetic.  The forward kernel returns y and each row's statistics,
(mean, rstd) with rstd negated where the clamp was active; the backward
kernel takes them back with x and dy, and returns dx in x's dtype and the
weight's and bias's gradients in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from tdr_torch.ops import cuda_build
from tdr_torch.ops.precision import compute_dtype
from tdr_torch.utils.trace import count

EPS = 1e-6                       # flax's default
MAX_D = 8192
_DTYPES = (torch.bfloat16, torch.float32)

# (device index, D, bf16) -> the backward's persistent grid on that card
_bwd_blocks: Dict[Tuple[int, int, bool], int] = {}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """The forward in plain torch ops: the CPU path, and what the forward
    kernel computes."""
    x = x.to(compute_dtype(x))
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return (x - mu) * mul + bias


def layer_norm_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor, eps: float = EPS
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The gradients of ``layer_norm_plain`` in closed form, (dx in x's
    dtype, dweight, dbias), with the backward kernel's arithmetic: with
    ``xh = (x - mean) * rstd`` and ``g = dy * weight``, ``dx = ((g -
    mean(g)) - xh * mean(g * xh)) * rstd``, the ``xh`` term dropped where
    the variance's clamp at 0 is active (no gradient flows through the
    variance there, as ``clamp_min``'s backward); ``dweight`` sums ``dy *
    xh`` over the rows, ``dbias`` sums ``dy``."""
    xf = x.to(compute_dtype(x))
    dy = dy.to(xf.dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    raw = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(raw.clamp_min(0.0) + eps)
    xh = (xf - mu) * rstd
    g = dy * weight
    c2 = torch.where(raw < 0, 0.0, (g * xh).mean(dim=-1, keepdim=True))
    dx = ((g - g.mean(dim=-1, keepdim=True)) - xh * c2) * rstd
    rows = tuple(range(dy.dim() - 1))
    return dx.to(x.dtype), (dy * xh).sum(dim=rows), dy.sum(dim=rows)


def check_args(x: torch.Tensor, *params: torch.Tensor) -> int:
    """Raises ``ValueError`` unless the kernels take ``x`` (..., D), bf16 or
    f32, and ``params``, each (D,) f32, all contiguous, 16-byte aligned and
    on one device, with D a multiple of 4 up to ``MAX_D``.  Returns D."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"layer_norm kernel: x is {x.dtype}, not bfloat16 "
                         f"or float32")
    D = x.shape[-1] if x.dim() else 0
    if D % 4 or not 4 <= D <= MAX_D:
        raise ValueError(f"layer_norm kernel: width {D}; needs a multiple "
                         f"of 4 from 4 to {MAX_D}")
    if x.numel() // D >= 2 ** 31:
        raise ValueError(f"layer_norm kernel: {x.numel() // D} rows; at "
                         f"most 2**31 - 1")
    for i, p in enumerate(params):
        if p.dtype != torch.float32 or tuple(p.shape) != (D,):
            raise ValueError(f"layer_norm kernel: parameter {i} is "
                             f"{tuple(p.shape)} {p.dtype}, not ({D},) "
                             f"float32")
    for t in (x, *params):
        if t.device != x.device:
            raise ValueError("layer_norm kernel: operands on "
                             f"{x.device} and {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("layer_norm kernel: operands must be contiguous "
                             "and 16-byte aligned")
    return D


def _need_cuda(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"layer_norm kernel: a {x.device} tensor; CUDA "
                         f"tensors only")


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (x's shape, f32) and the statistics (rows, 2) f32."""
    _need_cuda(x)
    D = check_args(x, weight, bias)
    rows = x.numel() // D
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, stats
    cuda_build.launch("layer_norm_fwd", "tdr_layer_norm_fwd", x.device,
                      x.data_ptr(), int(x.dtype == torch.bfloat16),
                      weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                      stats.data_ptr(), rows, D, eps)
    return y, stats


def _blocks(x: torch.Tensor, D: int) -> int:
    key = (x.device.index, D, x.dtype == torch.bfloat16)
    if key not in _bwd_blocks:
        n = ctypes.c_int(0)
        with torch.cuda.device(x.device):   # asks the current device
            err = cuda_build.lib().tdr_layer_norm_bwd_blocks(
                int(key[2]), D, ctypes.byref(n))
        cuda_build.check(err, "layer_norm_bwd")
        _bwd_blocks[key] = n.value
    return _bwd_blocks[key]


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                   stats: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dweight f32, dbias f32) from dy (x's shape, f32)
    and the forward's statistics."""
    _need_cuda(x)
    D = check_args(x, weight)
    rows = x.numel() // D
    if (dy.dtype != torch.float32 or dy.shape != x.shape
            or stats.dtype != torch.float32
            or tuple(stats.shape) != (rows, 2)):
        raise ValueError(f"layer_norm kernel: dy {tuple(dy.shape)} "
                         f"{dy.dtype} and stats {tuple(stats.shape)} "
                         f"{stats.dtype} for x {tuple(x.shape)}; both f32")
    for t in (dy, stats):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("layer_norm kernel: dy and stats must be "
                             "contiguous, 16-byte aligned and on x's device")
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = (torch.empty_like(weight) for _ in range(2))
    blocks = _blocks(x, D)
    part = torch.empty((blocks, 2, D), dtype=torch.float32, device=x.device)
    cuda_build.launch("layer_norm_bwd", "tdr_layer_norm_bwd", x.device,
                      dy.data_ptr(), x.data_ptr(),
                      int(x.dtype == torch.bfloat16), weight.data_ptr(),
                      stats.data_ptr(), dx.data_ptr(), part.data_ptr(),
                      blocks, dw.data_ptr(), db.data_ptr(), rows, D)
    return dx, dw, db


class _LayerNormKernel(torch.autograd.Function):
    """``layer_norm_plain`` as the two kernels: the backward recomputes
    x-hat from x and each row's saved mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, stats = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy.contiguous(), x, weight, stats)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = EPS) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis, f32 out: the kernels on a CUDA
    tensor (bf16 or f32, or ``check_args`` raises), ``layer_norm_plain`` on
    a CPU tensor.  While a profiler records, counts the rows under
    ``encoder.ln_rows``, and those the kernels took under
    ``encoder.ln_rows_kernel``."""
    rows = math.prod(x.shape[:-1])
    count("encoder.ln_rows", rows)
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps)
    y = _LayerNormKernel.apply(x, weight, bias, eps)
    count("encoder.ln_rows_kernel", rows)
    return y
