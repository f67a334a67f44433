"""The train step's AdamW (``tdr_torch.ops.adamw.AdamW``) on CPU.

On the card each param group's update is one launch of the hand-written
kernel of ``tdr_torch/csrc/adamw.cu``, which ``chip_smoke.py`` holds
against torch's foreach path.  These tests hold the chunk table's
arithmetic (every element of every tensor taken once, with the kernel's
head, vector and tail split modelled line for line), the CPU path to
``torch.optim.AdamW`` bit for bit, the kernel path's plumbing (state,
step counts, scalars, the table's cache, the counters) with a stand-in for
the kernel that does its arithmetic on the table's slices, the state's
round trips, the class name the profiler's range carries, and the checks
that refuse what the kernel does not compute.
"""

import ctypes
import io

import numpy as np
import pytest

from tests.torch_threads import torch

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tdr_torch.ops import adamw as adamw_op  # noqa: E402
from tdr_torch.ops import cuda_build  # noqa: E402
from tdr_torch.train import contrastive as tc  # noqa: E402
from tdr_torch.utils import trace  # noqa: E402

C = adamw_op.CHUNK
SHAPES = [(1,), (3,), (383,), (384,), (2, 3, 64), (C - 1,), (C,), (C + 1,),
          (2 * C + 5,), (3, C // 2 + 3)]


def _kernel_parts(row, grads):
    """What ``tdr_adamw_kernel``'s block takes of one table row, whose
    gradient pointer is ``grads[tensor]``: the elements (offsets into the
    row's tensors) one by one before the first 16-byte boundary, in 16-byte
    vectors, and one by one after the last vector; with the kernel's
    arithmetic."""
    p, m, v, tensor, start, n = (int(x) for x in row)
    addr = [x + 4 * start for x in (p, grads[tensor], m, v)]
    a = addr[0] & 15
    shared = all((x & 15) == a for x in addr[1:])
    head = min((((16 - a) & 15) >> 2) if shared else n, n)
    nvec = (n - head) >> 2
    tail = head + 4 * nvec
    if nvec:
        assert all((x + 4 * head) % 16 == 0 for x in addr)
    return (range(start, start + head),
            range(start + head, start + tail),
            range(start + tail, start + n))


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1), (3, 3, 3, 3),
                                     (0, 1, 2, 3), (2, 0, 2, 0)])
def test_chunk_table_covers_every_element_once(offsets):
    """Sizes around the vector width, a row of 384, and on each side of a
    chunk; data pointers 16-byte aligned plus ``offsets`` floats."""
    numels = [int(np.prod(s)) for s in SHAPES] + [0]
    base = 1 << 40
    ptrs, at = [], base
    for n in numels:
        ptrs.append(tuple(at + j * (1 << 36) + 4 * o
                          for j, o in enumerate(offsets)))
        at += 16 * (n + 8)
    grads = [ptr[1] for ptr in ptrs]
    rows = adamw_op.chunk_table(numels, [(p, m, v) for p, _, m, v in ptrs])
    assert rows.dtype == np.int64 and rows.shape[1] == 6
    assert len(rows) == sum(-(-n // C) for n in numels)
    assert (rows[:, 5] >= 1).all() and (rows[:, 5] <= C).all()
    seen = {ptr[0]: np.zeros(n, np.int64) for n, ptr in zip(numels, ptrs)}
    vectors = 0
    for row in rows:
        p, _, m, v = ptrs[row[3]]
        assert tuple(row[:3]) == (p, m, v)
        for part in _kernel_parts(row, grads):
            seen[int(row[0])][part.start:part.stop] += 1
        vectors += len(_kernel_parts(row, grads)[1])
    for n, ptr in zip(numels, ptrs):
        assert (seen[ptr[0]] == 1).all(), n
    if len(set(offsets)) == 1 and offsets[0] == 0:
        # every row of an aligned tensor starts aligned: all but the last
        # few elements of each tensor go in vectors
        assert vectors == sum(n - n % 4 for n in numels)
    if len(set(offsets)) > 1:
        assert vectors == 0


def test_chunk_table_refuses_a_chunk_off_the_vector_width():
    with pytest.raises(ValueError):
        adamw_op.chunk_table([8], [(0, 0, 0)], chunk=6)


def _model(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).requires_grad_()
            for s in [(7, 5), (384,), (3,), (2, 4, 9)]]


def _grads(params, step, skip=()):
    g = torch.Generator().manual_seed(100 + step)
    for i, p in enumerate(params):
        p.grad = None if i in skip else torch.randn(
            p.shape, generator=g).to(p.dtype)


def _run(opt_cls, params, steps=3, **kw):
    opt = opt_cls(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=0.01, **kw)
    for s in range(steps):
        # a None gradient among them: torch skips that parameter, whose
        # step count then falls behind the others'
        _grads(params, s, skip=(1,) if s == 1 else ())
        opt.step()
    return opt


def test_cpu_steps_equal_torch_bit_for_bit():
    mine, ref = _model(), _model()
    a = _run(adamw_op.AdamW, mine)
    b = _run(torch.optim.AdamW, ref)
    for p, q in zip(mine, ref):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.state[p][k], b.state[q][k])
    assert a.state[mine[1]]["step"].item() == 2.0
    assert a.state[mine[0]]["step"].item() == 3.0
    assert a.state[mine[0]]["step"].device.type == "cpu"
    assert a.table_builds == 0


def _stand_in(opt, calls):
    """The kernel's arithmetic, in torch ops, for ``cuda_build.launch``: the
    table's rows and the gradients' pointers read from the addresses the
    launch passes, each row's slices found by data pointer."""

    def launch(name, symbol, device, table, n_chunks, blocks, grads,
               n_tensors, *scalars):
        assert (name, symbol, blocks) == ("adamw", "tdr_adamw", 4)
        assert 0 < n_tensors <= adamw_op.MAX_TENSORS
        rows = np.ctypeslib.as_array((ctypes.c_int64 * (6 * n_chunks))
                                     .from_address(table)).reshape(-1, 6)
        gptr = np.ctypeslib.as_array((ctypes.c_int64 * n_tensors)
                                     .from_address(grads))
        decay, w1, beta2, omb2, step, bc2s, eps = (
            torch.tensor(x, dtype=torch.float32) for x in scalars)
        flat = {}
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    st = opt.state[p]
                    for t in (p, p.grad, st["exp_avg"], st["exp_avg_sq"]):
                        flat[t.data_ptr()] = t.view(-1)
        for row in rows.tolist():
            sl = slice(row[4], row[4] + row[5])
            p, m, v = (flat[x][sl] for x in row[:3])
            g = flat[int(gptr[row[3]])][sl]
            p.mul_(decay)
            m.add_(w1 * (g - m))
            v.mul_(beta2).add_(omb2 * (g * g))
            p.add_(step * (m / (v.sqrt() / bc2s + eps)))
        calls.append((n_chunks, device, tuple(scalars)))

    return launch


def close(x, y):
    """The stand-in against torch: the same operations, each rounded once;
    torch's CPU kernels may fuse a multiply-add that the stand-in rounds
    twice, an ulp or two of the terms, which the lerp's difference g - m
    or the update of a weight near 0 can leave larger than an ulp of the
    result."""
    torch.testing.assert_close(x, y, rtol=2 ** -20,
                               atol=2 ** -20 * float(y.detach().abs().max()))


@pytest.fixture
def kernel_path(monkeypatch):
    """``AdamW`` takes its kernel path on CPU tensors, with ``_stand_in``
    for the kernel and no device copy; yields the list of launches."""
    calls = []
    monkeypatch.setattr(adamw_op, "on_card", lambda p: True)
    monkeypatch.setattr(adamw_op, "upload",
                        lambda rows, device: torch.from_numpy(rows))
    monkeypatch.setattr(adamw_op, "_grid_blocks", lambda device: 4)
    real_init = adamw_op.AdamW.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        monkeypatch.setattr(cuda_build, "launch", _stand_in(self, calls))

    monkeypatch.setattr(adamw_op.AdamW, "__init__", init)
    yield calls


def test_kernel_path_steps_as_torch_does(kernel_path):
    mine, ref = _model(), _model()
    a = _run(adamw_op.AdamW, mine)
    b = _run(torch.optim.AdamW, ref)
    for p, q in zip(mine, ref):
        close(p, q)
        for k in ("exp_avg", "exp_avg_sq"):
            close(a.state[p][k], b.state[q][k])
        assert torch.equal(a.state[p]["step"], b.state[q]["step"])
        assert a.state[p]["step"].device.type == "cpu"
    # one launch a step; step 3 two, since parameter 1 skipped step 2 and
    # so has its own bias corrections
    assert [c[0] for c in kernel_path] == [4, 3, 3, 1]
    want = [adamw_op.step_scalars(1e-2, (0.9, 0.999), 1e-8, 0.01, t)
            for t in (1, 2, 3, 2)]
    assert [c[2] for c in kernel_path] == want
    # a table for each set of parameters launched together: the gradients'
    # new storage each step builds none
    assert a.table_builds == 3


def test_kernel_path_splits_a_group_over_launches(kernel_path, monkeypatch):
    """More parameters than a launch's gradient slots: several launches, the
    same update."""
    monkeypatch.setattr(adamw_op, "MAX_TENSORS", 3)
    mine, ref = _model() + _model(1), _model() + _model(1)
    a = _run(adamw_op.AdamW, mine, steps=2)
    _run(torch.optim.AdamW, ref, steps=2)
    # step 1: 8 tensors as 3 + 3 + 2; step 2 (parameter 1 skipped): 7 as
    # 3 + 3 + 1
    assert [c[0] for c in kernel_path] == [3, 3, 2, 3, 3, 1]
    assert a.table_builds == 6
    for p, q in zip(mine, ref):
        close(p, q)


def test_kernel_path_builds_a_table_once(kernel_path):
    params = _model()
    opt = adamw_op.AdamW(params, lr=1e-3)
    _grads(params, 0)
    for _ in range(3):
        opt.step()
    assert opt.table_builds == 1 and len(kernel_path) == 3
    # gradients in new storage: the same table
    _grads(params, 1)
    opt.step()
    assert opt.table_builds == 1
    # a moment in new storage: a new table
    opt.state[params[2]]["exp_avg"] = opt.state[params[2]]["exp_avg"].clone()
    opt.step()
    opt.step()
    assert opt.table_builds == 2


def test_step_scalars_are_the_foreach_paths():
    lr, (b1, b2), eps, wd = 3e-4, (0.9, 0.999), 1e-8, 0.01
    for t in (1.0, 2.0, 1000.0):
        got = adamw_op.step_scalars(lr, (b1, b2), eps, wd, t)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        assert got == (1 - lr * wd, 1 - b1, b2, 1 - b2, (lr / bc1) * -1,
                       bc2 ** 0.5, eps)


def test_state_dict_round_trip():
    params = _model()
    a = _run(adamw_op.AdamW, params, steps=2)
    twin = [p.detach().clone().requires_grad_() for p in params]
    b = adamw_op.AdamW(twin, lr=1.0)
    buf = io.BytesIO()
    torch.save(a.state_dict(), buf)
    buf.seek(0)
    b.load_state_dict(torch.load(buf))
    assert b.param_groups[0]["lr"] == 1e-2
    _grads(params, 7)
    _grads(twin, 7)
    a.step()
    b.step()
    for p, q in zip(params, twin):
        assert torch.equal(p, q)
        assert torch.equal(a.state[p]["exp_avg_sq"], b.state[q]["exp_avg_sq"])


def test_load_and_read_moments():
    params = _model()
    named = [(f"w{i}", p) for i, p in enumerate(params)]
    opt = adamw_op.AdamW(params, lr=1e-3)
    mu = {n: torch.full_like(p, 0.5) for n, p in named}
    nu = {n: torch.full_like(p, 0.25) for n, p in named}
    tc.load_adam_moments(opt, named, 4, mu, nu)
    count, got_mu, got_nu = tc.optimizer_moments(opt, named)
    assert count == 4
    for n, _ in named:
        assert torch.equal(got_mu[n], mu[n]) and torch.equal(got_nu[n], nu[n])
    assert opt.state[params[0]]["step"].dtype == torch.float32


def test_loaded_moments_take_their_parameters_layout(kernel_path):
    """Moments carried from flax's layout come as transposed views; loaded,
    they are laid out like their parameter, which the kernel path takes."""
    params = _model()
    named = [(f"w{i}", p) for i, p in enumerate(params)]
    opt = adamw_op.AdamW(params, lr=1e-3)
    mu = {n: torch.randn(tuple(reversed(p.shape))).permute(
        *reversed(range(p.dim()))) for n, p in named}
    nu = {n: m * m for n, m in mu.items()}
    assert not mu["w0"].is_contiguous()
    tc.load_adam_moments(opt, named, 1, mu, nu)
    for n, p in named:
        st = opt.state[p]
        assert st["exp_avg"].stride() == p.stride()
        assert torch.equal(st["exp_avg"], mu[n])
        assert torch.equal(st["exp_avg_sq"], nu[n])
    _grads(params, 0)
    opt.step()
    assert len(kernel_path) == 1


def test_the_train_state_takes_it():
    from tdr_torch.utils.config import DenseConfig

    cfg = DenseConfig(vocab_size=300, dim=32, depth=1, heads=2, max_len=8)
    state = tc.create_train_state(cfg, lr=1e-3, device="cpu")
    assert type(state.optimizer) is adamw_op.AdamW
    assert type(state.optimizer).__name__ == "AdamW"
    assert isinstance(state.optimizer, torch.optim.AdamW)


def test_profiler_range_and_hooks_once_per_step():
    """One ``Optimizer.step#AdamW.step`` range a step (tdrbench's
    ``adamw_ms_per_step`` reads it) and each hook once, also after a plain
    ``torch.optim.AdamW`` has wrapped torch's own step."""
    torch.optim.AdamW(_model(), lr=1e-3)
    params = _model()
    opt = adamw_op.AdamW(params, lr=1e-3)
    calls = []
    opt.register_step_pre_hook(lambda *a: calls.append("pre"))
    opt.register_step_post_hook(lambda *a: calls.append("post"))
    _grads(params, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt.step()
    names = [e.name for e in prof.events()]
    assert names.count("Optimizer.step#AdamW.step") == 1
    assert calls == ["pre", "post"]


def test_the_launch_is_an_op_inside_the_steps_range(kernel_path):
    """The profiler links a kernel to the op around its launch, not to a
    user range such as the step's: the launch is the op
    ``tdr_torch::adamw_``, inside ``Optimizer.step#AdamW.step``."""
    params = _model()
    opt = adamw_op.AdamW(params, lr=1e-3)
    _grads(params, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt.step()
    ev = {e.name: e for e in prof.events()}
    step, op = ev["Optimizer.step#AdamW.step"], ev["tdr_torch::adamw_"]
    assert step.time_range.start <= op.time_range.start
    assert op.time_range.end <= step.time_range.end
    assert len(kernel_path) == 1


def test_counters_only_while_a_profiler_records(kernel_path, monkeypatch):
    params = _model()
    n_all = sum(p.numel() for p in params)
    opt = adamw_op.AdamW(params, lr=1e-3)
    _grads(params, 0, skip=(3,))
    trace.reset_counters()
    opt.step()
    assert trace.counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        opt.step()
    assert trace.counters == {"adamw.params": n_all - params[3].numel(),
                              "adamw.params_kernel": n_all - params[3].numel()}
    # the CPU path counts what it updated, none of it by the kernel
    monkeypatch.setattr(adamw_op, "on_card", lambda p: False)
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        opt.step()
    assert trace.counters == {"adamw.params": n_all - params[3].numel()}
    trace.reset_counters()


@pytest.mark.parametrize("case", ["amsgrad", "maximize", "bf16_param",
                                  "noncontiguous_grad",
                                  "sparse_grad", "tensor_lr", "cpu_beside"])
def test_the_kernel_path_refuses_what_it_does_not_compute(case, monkeypatch):
    params = _model()
    cpu_param = params[2]
    monkeypatch.setattr(adamw_op, "upload",
                        lambda rows, device: torch.from_numpy(rows))
    monkeypatch.setattr(adamw_op, "adamw_update", lambda *a: None)
    monkeypatch.setattr(adamw_op, "on_card", lambda p: True)
    kw = {}
    if case in ("amsgrad", "maximize"):
        kw[case] = True
    elif case == "tensor_lr":
        kw["lr"] = torch.tensor(1e-3)
    elif case == "bf16_param":
        params[0] = params[0].detach().to(torch.bfloat16).requires_grad_()
    elif case == "cpu_beside":
        monkeypatch.setattr(adamw_op, "on_card", lambda p: p is not cpu_param)
    opt = adamw_op.AdamW(params, **kw)
    _grads(params, 0)
    if case == "noncontiguous_grad":
        params[0].grad = torch.randn(5, 7).t()
    elif case == "sparse_grad":
        params[1].grad = params[1].grad.to_sparse()
    with pytest.raises(ValueError):
        opt.step()
