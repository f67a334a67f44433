"""The yardstick's arithmetic against hand-worked cases."""

import pytest

from tdrbench.harness import arith


def test_model_flops():
    # 1,024 pairs = 2,048 sequences of 128 tokens at d 384, 6 layers
    f = arith.encoder_step_flops(2048, 128, 384, 6)
    assert f == 3 * 6 * 262_144 * (24 * 384 ** 2 + 4 * 128 * 384)
    assert f == pytest.approx(1.762e13, rel=1e-3)
    # chip_smoke.py's 11b step: 200 sequences (25,600 tokens); its
    # 1.726e12 counted the biases and LayerNorms too (6 x 10,647,552 params x tokens + the
    # attention), which this formula leaves out: 0.3% apart
    assert arith.encoder_step_flops(200, 128, 384, 6) == pytest.approx(
        1.726e12, rel=5e-3)
