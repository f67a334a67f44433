"""The 3xTF32 split of an f32 operand, in plain torch.

The f32 bodies of K2 (``csrc/fused_head.cu``) and K3 (``csrc/fused_flat.cu``)
run on the tensor cores in TF32, which keeps 10 of f32's 23 mantissa bits.
Each f32 operand x is split into ``big = tf32(x)`` and ``small = tf32(x -
big)``, and the kernels sum ``big·big + big·small + small·big`` with f32
accumulation: each product is then within about 2⁻²¹ of ``|x·y|`` (the
argument is in ``csrc/hopper.cuh``).  The kernels split their A operand
(the documents) in registers with ``cvt.rna.tf32.f32``; the wrappers split
the B operand (the queries) here, on the device, before the launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

_HALF = 1 << 12          # half a unit in the last of the 10 kept bits
_KEEP = ~((1 << 13) - 1)  # clears the 13 low mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 at the bit level: to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds; the 13 low mantissa bits of
    the result are zero.  Infinities and the canonical NaN pass through
    (their low mantissa bits are zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + _HALF) & _KEEP).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with ``big = tf32_round(x)`` and ``small =
    tf32_round(x - big)`` (the difference is exact in f32): both have their
    13 low mantissa bits zero, and ``big + small`` is within 2⁻²² ``|x|``
    of ``x``."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split: needs f32, got {x.dtype}")
    big = tf32_round(x)
    return big, tf32_round(x - big)
