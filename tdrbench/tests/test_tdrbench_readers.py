"""Each per-layer reader on a canned trace, against numbers worked by
hand."""

import pytest

from tdrbench.harness import common
from tdrbench.harness.trace import Op, Trace

K2 = "void fused_head_wgmma_kernel<128>(Params)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


def canned():
    """A 1,000 us window: kernels busy over [100, 300], [250, 400] (one
    interval [100, 400]) and [600, 700]; a copy [800, 850]; a kernel before
    the window is left out by ``from_profiler`` and so not here."""
    kernels = [(K2, 100.0, 200.0), ("radixSortKVInPlace", 250.0, 150.0),
               (GEMM, 600.0, 100.0), ("Memcpy DtoH (Device -> Pinned)",
                                      800.0, 50.0)]
    ops = [Op("tdrbench.window", 0.0, 1000.0, 0.0, -1),
           Op("tdrbench.call", 10.0, 990.0, 0.0, 0),
           Op("aten::sort", 240.0, 260.0, 150.0, 1),
           Op("aten::topk", 420.0, 580.0, 40.0, 1),
           Op("aten::sort", 430.0, 440.0, 30.0, 3),     # inside topk
           Op("Optimizer.step#AdamW.step", 590.0, 720.0, 100.0, 1),
           Op("aten::cat", 900.0, 990.0, 0.0, 1)]
    return Trace(0.0, 1000.0, kernels, ops, {"text_s_per_query": 4.5e-6})


def read(name, inputs, trace=None):
    return common.load_module("metrics", name).read(trace or canned(), inputs)


def test_busy_and_idle():
    t = canned()
    assert t.busy_s() == pytest.approx(450e-6)
    assert read("device_idle_pct.sparse", {}) == pytest.approx(55.0)
    assert read("device_idle_pct.train", {}) == pytest.approx(55.0)


def test_sort_topk_counts_a_nested_sort_once():
    # 150 + 40 us (the sort inside topk is in topk's 40) over 2,000 queries
    assert read("sort_topk_device_ms_per_kq", {"queries": 2000}) == \
        pytest.approx(0.19 / 2)


def test_kernels_per_kquery_leaves_copies_out():
    assert read("kernels_per_kq.sparse", {"queries": 500}) == pytest.approx(6.0)


def test_text_span():
    assert read("text_us_per_query", {}) == pytest.approx(4.5)


def test_untraced_rate_is_passed_on_and_absent_without_an_untraced_part():
    name = "queries_per_s.untraced_part"
    assert read(name, {"queries_per_s_untraced": 21000.5}) == 21000.5
    assert read(name, {"queries_per_s_untraced": None}) is None


def test_train_readers():
    inputs = {"steps": 2, "step_flops": 1e9, "peak_flops": 1e12}
    # 2e9 FLOP in a 1 ms window at 1e12 FLOP/s: twice the peak (a canned
    # case: a real share over 100% means the FLOPs or the time are wrong)
    assert read("train_mfu_pct", inputs) == pytest.approx(200.0)
    # the one kernel that is no product is the sort's 150 us (K2's wgmma
    # and the xmma GEMM are products, the copy is no kernel), less the
    # optimizer's 100 us, over 2 steps
    assert read("encoder_nongemm_ms_per_step", inputs) == pytest.approx(0.025)
    assert read("adamw_ms_per_step", inputs) == pytest.approx(0.05)


def test_breakdown_labels_gaps_by_the_innermost_op():
    b = canned().breakdown()
    ops = dict(b["device_ops"])
    assert ops[K2] == pytest.approx(200e-6)
    gaps = dict(b["idle_gaps"])
    # gaps [0,100] [400,600] [700,800] [850,1000]; midpoints 50, 500, 750,
    # 925: call, topk (its nested sort ends at 440), call, cat
    assert gaps["tdrbench.call"] == pytest.approx(200e-6)
    assert gaps["aten::topk"] == pytest.approx(200e-6)
    assert gaps["aten::cat"] == pytest.approx(150e-6)
