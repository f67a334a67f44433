"""The encoder's attention (``tdr_torch.ops.attention.attend``) on CPU.

On the card, bf16 heads take two hand-written kernels behind an autograd
``Function`` (``tdr_torch/csrc/attention.cu``), which ``chip_smoke.py``
holds against the plain versions here: ``attend_plain`` (the forward, the
CPU and f32 path) and ``attend_backward_plain`` (the backward in closed
form, with the kernel's arithmetic).  These tests hold the closed form to
autograd through the plain forward in float64, the mask's semantics (a
padded query row, a fully padded sequence), the CPU path to the ops the
encoder ran before bit for bit, the ``Function``'s plumbing with stand-ins
for the kernels, the row counters and their reader, and the kernels'
argument checks.
"""

import importlib.util
import math
import os

import pytest

from tests.torch_threads import torch

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tdr_torch.models import encoder  # noqa: E402
from tdr_torch.ops import attention as attn_op  # noqa: E402
from tdr_torch.ops import cuda_build  # noqa: E402
from tdr_torch.utils import trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _heads(B, H, L, Dh, dtype, seed=0, lengths=None):
    """q, k, v as (B, H, L, Dh) views of three (B, L, H * Dh) projections
    (the encoder's layout), dO (B, L, H * Dh) and the validity of each
    position: ``lengths`` (the first sequence full, the last fully padded
    by default)."""
    g = torch.Generator().manual_seed(seed)
    x = [(torch.randn(B, L, H * Dh, generator=g) * sd).to(dtype)
         for sd in (2.0, 1.0, 1.0)]
    q, k, v = (t.view(B, L, H, Dh).transpose(1, 2) for t in x)
    dout = torch.randn(B, L, H * Dh, generator=g).to(dtype)
    if lengths is None:
        lengths = [L] + [max(1, L - 3 * i) for i in range(1, B - 1)] + [0]
    valid = torch.arange(L)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, dout, valid


def _today(q, k, v, mask, dtype):
    """The encoder's attention as it was written before the kernels, on
    the (B, 1, L, L) mask."""
    B, H, L, Dh = q.shape
    q = q / torch.tensor(math.sqrt(Dh)).to(dtype)
    w = q @ k.transpose(-1, -2)
    w = w.masked_fill(~mask, torch.finfo(dtype).min)
    w = torch.softmax(w, dim=-1)
    return (w @ v).transpose(1, 2).reshape(B, L, H * Dh)


def _grads(fn, q, k, v, dout):
    """fn's output and its gradients to q, k and v, each taken through
    the (B, L, H * Dh) tensor the head view was made from."""
    B, H, L, Dh = q.shape
    leaves = [t.transpose(1, 2).reshape(B, L, H * Dh).detach()
              .requires_grad_() for t in (q, k, v)]
    heads = [t.view(B, L, H, Dh).transpose(1, 2) for t in leaves]
    out = fn(*heads)
    grads = torch.autograd.grad(out, leaves, dout)
    return (out,) + tuple(g.view(B, L, H, Dh).transpose(1, 2) for g in grads)


@pytest.mark.parametrize("B,H,L,Dh", [(4, 3, 16, 16), (3, 2, 40, 32),
                                      (2, 2, 136, 64)])
def test_closed_form_backward_matches_autograd_in_f64(B, H, L, Dh):
    q, k, v, dout, valid = _heads(B, H, L, Dh, torch.float64, seed=L)
    want = _grads(lambda *a: attn_op.attend_plain(*a, valid, torch.float64),
                  q, k, v, dout)
    got = attn_op.attend_backward_plain(dout, q, k, v, valid)
    for name, a, e in zip(("dq", "dk", "dv"), got, want[1:]):
        assert a.dtype == torch.float64 and a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12 * float(
            e.abs().max()), msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_padded_rows_and_sequences(dtype):
    B, H, L, Dh = 3, 2, 12, 16
    q, k, v, dout, valid = _heads(B, H, L, Dh, dtype, seed=3,
                                  lengths=[12, 5, 0])
    out = attn_op.attend_plain(q, k, v, valid, dtype)
    dq, dk, dv = attn_op.attend_backward_plain(dout, q, k, v, valid)
    for t in (out, dq, dk, dv):
        assert bool(torch.isfinite(t).all())
    # a padded query row attends to every position alike: the mean of v
    # (in bf16 the uniform 1/L is rounded, 1/12 by 2^-9 at most)
    mean_v = v.double().mean(dim=2).transpose(0, 1).reshape(H, B, Dh)
    for b, row in ((1, 7), (2, 0), (2, 11)):
        got = out[b, row].double().view(H, Dh)
        tol = 1e-12 if dtype == torch.float64 else 2e-2
        torch.testing.assert_close(got, mean_v[:, b], rtol=tol, atol=tol)
    # its dS row is 0, so its dq is, and it adds nothing to dk
    pad = ~valid[:, None, :, None].expand_as(dq)
    assert bool((dq[pad] == 0).all()) and bool((dq[~pad] != 0).any())
    assert bool((dk[2] == 0).all())
    # but its output's gradient reaches v through the uniform P
    assert bool((dv[2] != 0).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_ops_bit_for_bit(dtype):
    q, k, v, dout, valid = _heads(3, 4, 10, 16, dtype, seed=1)
    mask = attn_op.attention_mask(valid.int())
    before = dict(cuda_build.launches)
    got = _grads(lambda *a: attn_op.attend(*a, valid, dtype), q, k, v, dout)
    want = _grads(lambda *a: _today(*a, mask, dtype), q, k, v, dout)
    assert cuda_build.launches == before
    for a, e in zip(got, want):
        assert a.dtype == e.dtype == dtype and torch.equal(a, e)


def _stats_plain(q, k, valid):
    """Each row's softmax (max, sum) in f32, as the forward kernel saves
    them."""
    Dh = q.shape[-1]
    qs = q / attn_op._query_scale(Dh, q.dtype)
    s = (qs @ k.transpose(-1, -2)).masked_fill(
        ~attn_op.attention_mask(valid), torch.finfo(q.dtype).min).float()
    m = s.amax(dim=-1, keepdim=True)
    return torch.stack([m[..., 0], torch.exp(s - m).sum(dim=-1)], dim=-1)


def _stand_ins(monkeypatch):
    """CPU stand-ins for the two kernels, from the plain versions."""
    calls = []

    def fwd(q, k, v, valid):
        B, H, L, Dh = attn_op.check_args(q, k, v, valid)
        calls.append("fwd")
        return (attn_op.attend_plain(q, k, v, valid, torch.bfloat16),
                _stats_plain(q, k, valid))

    def bwd(dout, q, k, v, valid, stats):
        B, H, L, Dh = attn_op.check_args(q, k, v, valid)
        assert dout.is_contiguous() and dout.shape == (B, L, H * Dh)
        torch.testing.assert_close(stats, _stats_plain(q, k, valid))
        calls.append("bwd")
        return attn_op.attend_backward_plain(dout, q, k, v, valid)

    monkeypatch.setattr(attn_op, "attention_fwd", fwd)
    monkeypatch.setattr(attn_op, "attention_bwd", bwd)
    return calls


def test_the_function_carries_the_kernels_results(monkeypatch):
    calls = _stand_ins(monkeypatch)
    q, k, v, _, valid = _heads(4, 3, 24, 32, torch.bfloat16, seed=2)
    # a broadcast gradient: the Function hands the kernel a contiguous one
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(1, 24, 96, generator=g).to(torch.bfloat16)
    dout = dout.expand(4, 24, 96)
    got = _grads(lambda *a: attn_op._AttentionKernel.apply(*a, valid),
                 q, k, v, dout)
    assert calls == ["fwd", "bwd"]
    assert torch.equal(got[0], attn_op.attend_plain(q, k, v, valid,
                                                    torch.bfloat16))
    want = attn_op.attend_backward_plain(dout.contiguous(), q, k, v, valid)
    for a, e in zip(got[1:], want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e)
    # and they are the gradients autograd takes through the plain ops, up to
    # sums in another order and one bf16 rounding either way
    auto = _grads(lambda *a: attn_op.attend_plain(*a, valid, torch.bfloat16),
                  q, k, v, dout)
    for a, e in zip(got[1:], auto[1:]):
        torch.testing.assert_close(a.float(), e.float(), rtol=2 ** -6,
                                   atol=2 ** -6 * float(e.abs().max()))
    with torch.inference_mode():
        assert torch.equal(attn_op._AttentionKernel.apply(q, k, v, valid),
                           got[0])
    assert calls == ["fwd", "bwd", "fwd"]


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
    # 3 sequences x 2 heads x 8 query rows a block; none through the kernel
    assert trace.counters["encoder.attn_rows"] == cfg.depth * 48
    assert "encoder.attn_rows_kernel" not in trace.counters
    trace.reset_counters()


def test_the_kernel_share_reader(monkeypatch):
    path = os.path.join(REPO, "tdrbench", "metrics",
                        "attention_kernel_rows_pct.train.py")
    spec = importlib.util.spec_from_file_location("attn_share", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setattr(trace, "counters", {})
    assert reader.read(None, {}) is None            # a program without them
    monkeypatch.setattr(trace, "counters", {"encoder.attn_rows": 4096})
    assert reader.read(None, {}) == 0.0
    monkeypatch.setattr(trace, "counters", {"encoder.attn_rows": 4096,
                                            "encoder.attn_rows_kernel": 4096})
    assert reader.read(None, {}) == 100.0


def _ok(B=2, H=3, L=16, Dh=32):
    x = torch.zeros(3, B, L, H * Dh, dtype=torch.bfloat16)
    q, k, v = (t.view(B, L, H, Dh).transpose(1, 2) for t in x)
    return q, k, v, torch.ones(B, L, dtype=torch.bool)


@pytest.mark.parametrize("case", [
    "f32", "half", "three_d", "k_shape", "dh_48", "dh_128", "l_0", "l_513",
    "strides_differ", "last_stride", "row_stride_8", "misaligned",
    "valid_int", "valid_shape", "valid_strided"])
def test_the_kernel_argument_check_raises(case):
    q, k, v, valid = _ok()
    assert attn_op.check_args(q, k, v, valid) == (2, 3, 16, 32)
    if case == "f32":
        q = q.float()
    elif case == "half":
        v = v.half()
    elif case == "three_d":
        q, k, v = q[0], k[0], v[0]
    elif case == "k_shape":
        k = k[:, :2]
    elif case == "dh_48":
        q, k, v, valid = _ok(Dh=48)
    elif case == "dh_128":
        q, k, v, valid = _ok(Dh=128)
    elif case == "l_0":
        q, k, v, valid = _ok(L=0)
    elif case == "l_513":
        q, k, v, valid = _ok(L=512)
        assert attn_op.check_args(q, k, v, valid) == (2, 3, 512, 32)
        q, k, v, valid = _ok(L=513)
    elif case == "strides_differ":
        v = v.contiguous()
    elif case == "last_stride":
        x = torch.zeros(2, 3, 32, 16, dtype=torch.bfloat16)
        q = k = v = x.transpose(2, 3)
    elif case == "row_stride_8":
        x = torch.zeros(2, 16, 3 * 32 + 4, dtype=torch.bfloat16)
        q = k = v = x[..., :96].unflatten(-1, (3, 32)).transpose(1, 2)
    elif case == "misaligned":
        x = torch.zeros(2 * 16 * 96 + 8, dtype=torch.bfloat16)
        q = k = v = x[8:].view(2, 16, 3, 32).transpose(1, 2)
        assert attn_op.check_args(q, k, v, valid) == (2, 3, 16, 32)
        q = k = v = x[1:2 * 16 * 96 + 1].view(2, 16, 3, 32).transpose(1, 2)
    elif case == "valid_int":
        valid = valid.int()
    elif case == "valid_shape":
        valid = valid[:, :8]
    elif case == "valid_strided":
        valid = torch.ones(16, 2, dtype=torch.bool).t()
    with pytest.raises(ValueError):
        attn_op.check_args(q, k, v, valid)


def test_the_kernel_wrappers_take_only_cuda_tensors():
    q, k, v, valid = _ok()
    with pytest.raises(ValueError):
        attn_op.attention_fwd(q, k, v, valid)
    with pytest.raises(ValueError):
        attn_op.attention_bwd(torch.zeros(2, 16, 96, dtype=torch.bfloat16),
                              q, k, v, valid, torch.zeros(2, 3, 16, 2))


def test_the_scale_is_the_plain_ops_divisor():
    for dh in attn_op.HEAD_DIMS:
        assert attn_op.scale_of(dh) == float(
            attn_op._query_scale(dh, torch.bfloat16))
    assert attn_op.scale_of(32) == 5.65625      # sqrt(32) in bf16
