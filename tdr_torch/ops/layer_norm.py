"""The encoder's LayerNorm as two CUDA kernels, forward and backward
(``tdr_torch/csrc/layer_norm.cu``).

``tdr_torch.models.encoder.layer_norm`` launches them on a CUDA tensor,
through an autograd ``Function``; what they compute, and the CPU path, are
that module's plain versions, ``layer_norm_plain`` and
``layer_norm_backward_plain``.  Here are the launches and the checks of
their operands.  The forward returns y in f32 and each row's statistics,
(mean, rstd) with rstd negated where the variance's clamp at 0 was active;
the backward takes them back with x and dy, and returns dx in x's dtype
and the weight's and bias's gradients in f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from tdr_torch.ops import cuda_build

MAX_D = 8192
_DTYPES = (torch.bfloat16, torch.float32)

# (device index, D, bf16) -> the backward's persistent grid on that card
_bwd_blocks: Dict[Tuple[int, int, bool], int] = {}


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
    with torch.cuda.device(x.device):  # launches on the current device
        err = cuda_build.lib().tdr_layer_norm_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), stats.data_ptr(), rows, D, eps,
            cuda_build.current_stream(x.device))
    cuda_build.check(err, "layer_norm_fwd")
    cuda_build.launches["layer_norm_fwd"] += 1
    return y, stats


def _blocks(lib, x: torch.Tensor, D: int) -> int:
    key = (x.device.index, D, x.dtype == torch.bfloat16)
    if key not in _bwd_blocks:
        n = ctypes.c_int(0)
        cuda_build.check(lib.tdr_layer_norm_bwd_blocks(int(key[2]), D,
                                                       ctypes.byref(n)),
                         "layer_norm_bwd")
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
    with torch.cuda.device(x.device):  # launches on the current device
        lib = cuda_build.lib()
        blocks = _blocks(lib, x, D)
        part = torch.empty((blocks, 2, D), dtype=torch.float32,
                           device=x.device)
        err = lib.tdr_layer_norm_bwd(
            dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
            weight.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            part.data_ptr(), blocks, dw.data_ptr(), db.data_ptr(), rows, D,
            cuda_build.current_stream(x.device))
    cuda_build.check(err, "layer_norm_bwd")
    cuda_build.launches["layer_norm_bwd"] += 1
    return dx, dw, db
