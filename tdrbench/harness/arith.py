"""The yardstick's arithmetic: the card's peaks and the dense encoder's
model FLOPs.  A frozen copy of what ``chip_smoke.py`` computes (its 11b
model FLOPs), so that the numbers do not move when the program changes."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BYTES_PER_S = 3.35e12          # HBM3
PEAK_BF16_FLOPS = 989e12            # bf16 tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12              # outside the tensor cores


def encoder_step_flops(n_seq: int, seq_len: int, dim: int, depth: int) -> float:
    """Model FLOPs of one training step of a pre-LN encoder: 3 (forward and
    backward) x layers x tokens x (24 d^2 + 4 L d), the projections' and the
    MLP's 12 d^2 MACs a token at 2 FLOP a MAC, and attention's two L x d
    products a token."""
    tokens = n_seq * seq_len
    return 3.0 * depth * tokens * (24.0 * dim * dim + 4.0 * seq_len * dim)
