"""The 3xTF32 split behind the f32 bodies of K2 and K3, on CPU.

``tdr_torch/csrc/fused_head.cu`` and ``fused_flat.cu`` run f32 operands on
the tensor cores as ``big·big + big·small + small·big`` with ``(big,
small) = tf32_split(x)`` and f32 accumulation.  The kernels themselves run
only on the card (``chip_smoke.py`` holds them against their plain
versions there); these tests check the split's bits and, by emulating the
three-product sum in f32 on the CPU, that it holds the tolerances
``chip_smoke.py`` applies to the kernels (K2: rtol 1e-5, atol 1e-6; K3:
rtol 1e-5, atol 1e-5) against an f64 product, where one TF32 product does
not.  Inputs come from numpy seeds.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

from tdr_torch.ops.tf32 import tf32_round, tf32_split  # noqa: E402

LOW13 = (1 << 13) - 1
TOL = {"k2_head": (1e-5, 1e-6), "k3_ip": (1e-5, 1e-5), "k3_l2": (1e-5, 1e-5)}


def _values(kind, seed, n=1 << 14):
    rs = np.random.RandomState(seed)
    if kind == "normal":
        x = rs.randn(n)
    elif kind == "wide":                      # 2^-40 .. 2^40, both signs
        x = np.exp2(rs.uniform(-40, 40, n)) * rs.choice([-1.0, 1.0], n)
    elif kind == "unit":
        x = rs.randn(n // 64, 64)
        x = (x / np.linalg.norm(x, axis=1, keepdims=True)).ravel()
    else:                                     # BM25-like: >= 0, mostly zero
        x = rs.gamma(2.0, 1.5, n) * (rs.rand(n) < 0.1)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "unit", "bm25"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_bits_and_remainder(kind, seed):
    x = _values(kind, seed)
    big, small = tf32_split(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & LOW13).any())
    # big is x to nearest at 10 mantissa bits; the rest is small's
    x64, b64, s64 = x.double(), big.double(), small.double()
    assert bool(((x64 - b64).abs() <= 2.0 ** -11 * x64.abs()).all())
    assert bool(((x64 - b64 - s64).abs() <= 2.0 ** -22 * x64.abs()).all())


def test_round_ties_away_from_zero_and_passes_non_finite():
    # 1 + 2^-11 lies half way between two TF32 values: away from zero
    one_half_ulp = 1.0 + 2.0 ** -11
    x = torch.tensor([one_half_ulp, -one_half_ulp, 1.0 + 2.0 ** -12,
                      float("inf"), float("-inf"), 0.0, -0.0],
                     dtype=torch.float32)
    r = tf32_round(x)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         float("inf"), float("-inf"), 0.0, -0.0])
    assert torch.equal(r, want)
    assert torch.isnan(tf32_round(torch.tensor([float("nan")])))[0]
    with pytest.raises(ValueError):
        tf32_split(torch.zeros(3, dtype=torch.bfloat16))


def _operands(case):
    """(A (docs, depth), B (queries, depth), alpha, bias (docs,)) in f32:
    the kernels' orientation, documents on M and queries on N."""
    rs = np.random.RandomState({"k2_head": 3, "k3_ip": 4, "k3_l2": 5}[case])
    if case == "k2_head":
        # BM25 head columns (non-negative, sparse) over a wide exponent
        # range, and non-negative slot-summed query weights
        n, d, q = 4096, 512, 64
        a = (rs.gamma(2.0, 1.5, (n, d)) * np.exp2(rs.uniform(-12, 4, (n, d)))
             * (rs.rand(n, d) < 0.05))
        b = rs.gamma(1.0, 2.0, (q, d)) * (rs.rand(q, d) < 0.1)
        return (torch.from_numpy(a.astype(np.float32)),
                torch.from_numpy(b.astype(np.float32)), 1.0,
                torch.zeros(n))
    # unit embeddings against the dense bench's randn queries: inner
    # products that cancel, and l2's alpha 2 with bias -|d|^2
    n, d, q = 4096, 256, 64
    a = rs.randn(n, d)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rs.randn(q, d)
    a = torch.from_numpy(a.astype(np.float32))
    b = torch.from_numpy(b.astype(np.float32))
    if case == "k3_ip":
        return a, b, 1.0, torch.zeros(n)
    return a, b, 2.0, -(a.double() ** 2).sum(1).float()


def _group_max(s):
    return s.view(s.shape[0], -1, 8).amax(-1)


def _three_products(a, b):
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    return bs @ ab.T + bb @ as_.T + bb @ ab.T     # (queries, docs), f32


def _one_product(a, b):
    return tf32_round(b) @ tf32_round(a).T


def _check(case, product):
    a, b, alpha, bias = _operands(case)
    ref = _group_max(alpha * (b.double() @ a.double().T) + bias.double())
    got = _group_max(alpha * product(a, b) + bias).double()
    rtol, atol = TOL[case]
    return (got - ref).abs() <= rtol * ref.abs() + atol


@pytest.mark.parametrize("case", sorted(TOL))
def test_three_products_hold_the_kernel_tolerance(case):
    assert bool(_check(case, _three_products).all())


@pytest.mark.parametrize("case", sorted(TOL))
def test_one_tf32_product_fails_the_same_tolerance(case):
    assert not bool(_check(case, _one_product).all())
