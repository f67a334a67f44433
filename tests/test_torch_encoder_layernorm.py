"""The encoder's LayerNorm (``tdr_torch.ops.layer_norm.layer_norm``) on CPU.

On the card it is two hand-written kernels behind an autograd ``Function``
(``tdr_torch/csrc/layer_norm.cu``), which ``chip_smoke.py`` holds against
the plain versions here: ``layer_norm_plain`` (the forward, the CPU path)
and ``layer_norm_backward_plain`` (the backward in closed form, with the
kernel's arithmetic).  These tests hold the closed form to autograd through
the plain forward in float64, the CPU path to the plain ops bit for bit,
the ``Function``'s plumbing with stand-ins for the kernels, the row
counters, and the kernels' argument checks.
"""

import importlib.util
import os

import pytest

from tests.torch_threads import torch

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tdr_torch.models import encoder  # noqa: E402
from tdr_torch.ops import cuda_build  # noqa: E402
from tdr_torch.ops import layer_norm as ln_op  # noqa: E402
from tdr_torch.utils import trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 6


def _params(D, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = 1.0 + 0.5 * torch.randn(D, generator=g)
    b = 0.2 * torch.randn(D, generator=g)
    return w.to(dtype), b.to(dtype)


def _raw_variance(x):
    """The fast variance before its clamp, as ``layer_norm_plain`` takes it."""
    mu = x.mean(dim=-1, keepdim=True)
    return ((x * x).mean(dim=-1, keepdim=True) - mu * mu)[..., 0]


def _with_clamped_row(x, row):
    """``x`` with row ``row`` set to a value and its next float above,
    alternating, at the first of a few magnitudes where the fast variance
    (E[x²] - mean², rounded in x's dtype) comes out below 0."""
    for mag in range(1, 60):
        c = torch.tensor(1.37 * 1.17 ** mag, dtype=x.dtype)
        up = torch.nextafter(c, torch.tensor(float("inf"), dtype=x.dtype))
        x[row] = torch.where(torch.arange(x.shape[-1]) % 2 == 0, c, up)
        if _raw_variance(x)[row] < 0:
            return x
    raise AssertionError("no row with a negative fast variance")


@pytest.mark.parametrize("values", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [384, 768])
def test_closed_form_backward_matches_autograd_in_f64(D, values):
    g = torch.Generator().manual_seed(D)
    x = torch.randn(ROWS, D, generator=g).to(values).double()
    x = _with_clamped_row(x, 2)
    assert _raw_variance(x)[2] < 0 <= _raw_variance(x)[0]
    w, b = _params(D, torch.float64)
    dy = torch.randn(ROWS, D, generator=g, dtype=torch.float64)
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    want = torch.autograd.grad(ln_op.layer_norm_plain(xa, wa, ba),
                               (xa, wa, ba), dy)
    got = ln_op.layer_norm_backward_plain(dy, x, w)
    for name, a, e in zip(("dx", "dweight", "dbias"), got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12 * float(
            e.abs().max()), msg=name)
    # where the clamp is active only the mean's path reaches x
    w_dy = dy[2] * w
    torch.testing.assert_close(
        got[0][2], (w_dy - w_dy.mean()) * torch.rsqrt(torch.tensor(1e-6,
                                                      dtype=torch.float64)))


def _today(x, weight, bias, eps):
    """The encoder's LayerNorm as it was written before the kernels."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return (x - mu) * mul + bias


def _grads(fn, x, w, b, dy):
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    y = fn(xa, wa, ba)
    return (y,) + torch.autograd.grad(y, (xa, wa, ba), dy)


@pytest.mark.parametrize("dtype,eps", [(torch.bfloat16, 1e-6),
                                       (torch.float32, 1e-12)])
def test_cpu_tensors_take_the_plain_ops_bit_for_bit(dtype, eps):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 384, generator=g).to(dtype)
    w, b = _params(384)
    dy = torch.randn(2, 5, 384, generator=g)
    before = dict(cuda_build.launches)
    got = _grads(lambda *a: ln_op.layer_norm(*a, eps=eps), x, w, b, dy)
    want = _grads(lambda *a: _today(*a, eps), x, w, b, dy)
    assert cuda_build.launches == before
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)
    module = encoder.LayerNorm(384, eps)
    with torch.no_grad():
        module.weight.copy_(w)
        module.bias.copy_(b)
    assert torch.equal(module(x), want[0])


def _stand_ins(monkeypatch, eps):
    """CPU stand-ins for the two kernels, from the plain versions: the
    statistics as the forward kernel saves them (rstd negated where the
    clamp is active)."""
    calls = []

    def fwd(x, weight, bias, e):
        assert e == eps
        xf = x.float()
        raw = _raw_variance(xf).reshape(-1)
        rstd = torch.rsqrt(raw.clamp_min(0.0) + e)
        mean = xf.mean(dim=-1).reshape(-1)
        calls.append("fwd")
        return (ln_op.layer_norm_plain(x, weight, bias, e),
                torch.stack([mean, torch.where(raw < 0, -rstd, rstd)], 1))

    def bwd(dy, x, weight, stats):
        rows = x.numel() // x.shape[-1]
        assert dy.is_contiguous() and stats.shape == (rows, 2)
        calls.append("bwd")
        return ln_op.layer_norm_backward_plain(dy, x, weight, eps)

    monkeypatch.setattr(ln_op, "layer_norm_fwd", fwd)
    monkeypatch.setattr(ln_op, "layer_norm_bwd", bwd)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_function_carries_the_kernels_results(dtype, monkeypatch):
    eps = 1e-6
    calls = _stand_ins(monkeypatch, eps)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 384, generator=g).to(dtype)
    w, b = _params(384)
    # a broadcast gradient: the Function hands the kernel a contiguous one
    dy = torch.randn(1, 4, 384, generator=g).expand(3, 4, 384)
    got = _grads(lambda *a: ln_op._LayerNormKernel.apply(*a, eps),
                 x, w, b, dy)
    assert calls == ["fwd", "bwd"]
    assert torch.equal(got[0], _today(x, w, b, eps))
    want = ln_op.layer_norm_backward_plain(dy.contiguous(), x, w, eps)
    assert got[1].dtype == dtype
    for a, e in zip(got[1:], want):
        assert torch.equal(a, e)
    # and they are the gradients autograd takes through the plain ops, up
    # to f32 rounding in another order (dx rounded to bf16 for bf16 x)
    auto = _grads(lambda *a: _today(*a, eps), x, w, b, dy)
    for a, e in zip(got[1:], auto[1:]):
        tol = 1e-2 if a.dtype == torch.bfloat16 else 2e-4
        torch.testing.assert_close(a.float(), e.float(), rtol=tol,
                                   atol=tol * float(e.abs().max()))
    with torch.inference_mode():
        assert torch.equal(ln_op._LayerNormKernel.apply(x, w, b, eps),
                           got[0])


def test_rows_are_counted_only_while_a_profiler_records():
    from tdr_torch.utils.config import DenseConfig

    cfg = DenseConfig(vocab_size=300, dim=32, depth=2, heads=2, max_len=8)
    model = encoder.init_encoder(cfg, seed=0, device="cpu")
    ids = torch.randint(1, 300, (3, 8))
    mask = torch.ones(3, 8, dtype=torch.int32)
    trace.reset_counters()
    model(ids, mask)
    assert trace.counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        model(ids, mask)
    # 2 a block and the last one, over 3 x 8 rows; none through the kernel
    # (the attention counts its own rows, 3 x 2 heads x 8 a block)
    assert trace.counters == {"encoder.ln_rows": (2 * cfg.depth + 1) * 24,
                              "encoder.attn_rows": cfg.depth * 48}
    trace.reset_counters()


def test_the_kernel_share_reader(monkeypatch):
    path = os.path.join(REPO, "tdrbench", "metrics",
                        "layer_norm_kernel_rows_pct.train.py")
    spec = importlib.util.spec_from_file_location("ln_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setattr(trace, "counters", {})
    assert reader.read(None, {}) is None            # a program without them
    monkeypatch.setattr(trace, "counters", {"encoder.ln_rows": 4096})
    assert reader.read(None, {}) == 0.0
    monkeypatch.setattr(trace, "counters", {"encoder.ln_rows": 4096,
                                            "encoder.ln_rows_kernel": 4096})
    assert reader.read(None, {}) == 100.0


def _ok():
    return torch.zeros(2, 8), torch.ones(8), torch.zeros(8)


@pytest.mark.parametrize("case", [
    "wide", "narrow", "ragged", "half", "double", "noncontiguous",
    "weight_f64", "weight_shape"])
def test_the_kernel_argument_check_raises(case):
    x, w, b = _ok()
    assert ln_op.check_args(x, w, b) == 8
    if case == "wide":
        x, w, b = torch.zeros(2, 8192), torch.ones(8192), torch.zeros(8192)
        assert ln_op.check_args(x, w, b) == 8192
        x, w, b = torch.zeros(2, 8196), torch.ones(8196), torch.zeros(8196)
    elif case == "narrow":
        x, w, b = torch.zeros(2, 0), torch.ones(0), torch.zeros(0)
    elif case == "ragged":
        x, w, b = torch.zeros(2, 6), torch.ones(6), torch.zeros(6)
    elif case == "half":
        x = x.half()
    elif case == "double":
        x = x.double()
    elif case == "noncontiguous":
        x = torch.zeros(8, 2).t()
    elif case == "weight_f64":
        w = w.double()
    elif case == "weight_shape":
        b = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        ln_op.check_args(x, w, b)


def test_the_kernel_wrappers_take_only_cuda_tensors():
    x, w, b = _ok()
    with pytest.raises(ValueError):
        ln_op.layer_norm_fwd(x, w, b, 1e-6)
    with pytest.raises(ValueError):
        ln_op.layer_norm_bwd(x, x, w, torch.zeros(2, 2))
