"""Prefix sums in XLA's order.

``jnp.cumsum`` lowers to a reduce_window, which XLA on the CPU rewrites
into a blocked scan: sequential f32 prefix sums inside blocks of 16, the
same scan applied to the block totals, and each block's exclusive carry
added to its prefixes.  ``torch.cumsum`` on the CPU accumulates in f64
instead.  A segment sum taken as the difference of two prefix sums
inherits their rounding, so the PRF miner's pooled totals use
``xla_cumsum``: they then equal the JAX package's on the CPU bit for bit,
and its discrete top-E term choice breaks near-ties the same way.  The
sparse engine's tail sums use it on the CPU too, where the port is held
against the JAX package; on the card, where this function costs dozens
of small launches, the serving path takes one ``torch.cumsum`` and its
tail sums differ from the CPU's by the prefix sum's rounding.
"""

from __future__ import annotations

import torch

_BASE = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums along the last axis, in XLA's blocked
    order (base 16, recursive)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nb = -(-n // _BASE)
    blk = torch.nn.functional.pad(x, (0, nb * _BASE - n)).reshape(
        *lead, nb, _BASE).clone()
    for i in range(1, _BASE):                      # sequential inside a block
        blk[..., i] += blk[..., i - 1]
    if nb > 1:
        carry = xla_cumsum(blk[..., -1])           # inclusive block totals
        carry = torch.nn.functional.pad(carry[..., :-1], (1, 0))
        blk = blk + carry[..., None]
    return blk.reshape(*lead, nb * _BASE)[..., :n]
