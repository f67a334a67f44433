"""The cell that came with the MLA + MoE encoder, rehearsed on the CPU
through ``run.execute`` at a small cut of its own (``small.py`` holds the
first two cells'): ``dsv2lite-embed-train-b48`` (``mla_moe_train``).  A
sound run comes out correct, with and without the trace, and a traced one
reports the readers of the program's spans and counters; a run with its
timed path broken comes out not correct, once for each of its kind's
faults; so does the control, the reference in float8.  Also the frozen
arithmetic and the new readers on canned traces."""

import copy
import json
import sys

import pytest

import tdrbench.run as run
from tdrbench.harness import arith_mla_moe, common
from tdrbench.harness.trace import Op, Trace
from tdrbench.tests import small

SEED = 2**31 + 4321
MOE_CELL = "dsv2lite-embed-train-b48"


def moe():
    """hidden 64, 4 heads, nope 16, rope 8, v 16, latent 32, 8 experts
    top-2 with 1 shared, 1 dense + 2 MoE layers, 16 tokens, 8 pairs."""
    cfg = small.load("configs", "deepseek-v2-lite-5l-embed.json")
    cfg.update(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, intermediate_size=96, moe_intermediate_size=24,
               n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
               vocab_size=2000)
    mix = dict(small.load("traffic", "pairs-b48-l256.json"), pairs_per_step=8,
               seq_len=16, pool_docs=200, pool_pairs=256, reference_chunk=5)
    # at this width the sound bf16 step read loss gaps up to 1.7e-3,
    # gradient gaps up to 3.1e-3 and change gaps up to 1.6e-3 (4 seeds);
    # the float8 control 0.019, 0.051 and 0.012, and each fault above one
    # of these limits (the cell's own are set on the card)
    limits = {"loss_gap": 0.004, "grad_gap": 0.02, "change_gap": 0.01}
    return cfg, dict(mix, limits=limits)


CELLS = {MOE_CELL: moe}


def cell_files(name):
    if name not in CELLS:
        return small.cell_files(name)
    bench = common.benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    cfg, params = CELLS[name]()
    return bench, cell, copy.deepcopy(cfg), params


@pytest.fixture(autouse=True)
def small_cells(monkeypatch):
    """The small cells, and the kinds imported afresh: another file's
    planted fault may have left its broken ``Run`` in a registered kind
    that the new kind subclasses."""
    for name in [m for m in sys.modules if m.startswith("tdrbench.traffic.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(run, "cell_files", cell_files)


def execute(cell, trace=False):
    return run.execute(cell, SEED, 1.0, trace, device="cpu")


def plant(monkeypatch, broken):
    load = common.load_module

    def load_broken(folder, name):
        mod = load(folder, name)
        if folder == "traffic":
            mod.Run = broken
        return mod

    monkeypatch.setattr(common, "load_module", load_broken)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, trace):
    out = execute(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in common.metrics_of(common.benchmark(), section,
                                                  cell)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_the_moe_cell_reports_its_readers_on_a_traced_run():
    from tdr_torch.utils import trace

    trace.reset_counters()
    out = execute(MOE_CELL, trace=True)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # every new reader but the device's: a CPU run launches no kernel, so
    # the spans hold no device time and the shares of the peak read none
    assert got["moe_assignments_pct"] == pytest.approx(100.0)
    assert got["host_syncs_per_step.moe"] == pytest.approx(2.0)
    assert got["train_mfu_pct"] > 0
    trace.reset_counters()


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "token_altered", "top5", "no_shared",
                                   "no_mscale"])
def test_moe_faults_are_caught(fault, monkeypatch):
    kind = common.load_module("traffic", "mla_moe_train")

    class Broken(kind.Run):
        def __init__(self, *a):
            super().__init__(*a, fault=fault)

    plant(monkeypatch, Broken)
    out = execute(MOE_CELL)
    assert not out["correct"], out["checks"]


def test_moe_control_fails():
    """The reference in float8 in the program's place."""
    from tdrbench.reference import encoder as ref_enc

    kind = common.load_module("traffic", "mla_moe_train")
    _, _, cfg, params = cell_files(MOE_CELL)
    r = kind.Run(cfg, params, SEED, "cpu")
    r.setup()
    r.release()
    ref = r.readings()
    assert all(v <= lim for v, lim in r.check(ref).values())
    checks = r.check(ref, r.readings(ref_enc.fp8))
    assert any(v > lim for v, lim in checks.values()), checks


def test_weights_are_drawn_again_leaf_by_leaf():
    import torch

    kind = common.load_module("traffic", "mla_moe_train")
    cfg, _ = moe()
    a = dict(kind.make_weights(cfg, 7, "cpu", 0.02))
    b = dict(kind.make_weights(cfg, 7, "cpu", 0.02))
    assert list(a) == list(kind.weight_shapes(cfg))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = dict(kind.make_weights(cfg, 8, "cpu", 0.02))
    assert not torch.equal(a["tok_embed.weight"], c["tok_embed.weight"])


def test_the_config_file_keeps_the_published_widths():
    with open(f"{common.BENCH_DIR}/configs/deepseek-v2-lite-5l-embed.json") as f:
        cfg = json.load(f)
    published = {"hidden_size": 2048, "num_attention_heads": 16,
                 "kv_lora_rank": 512, "qk_nope_head_dim": 128,
                 "qk_rope_head_dim": 64, "v_head_dim": 128,
                 "n_routed_experts": 64, "moe_intermediate_size": 1408,
                 "num_experts_per_tok": 6, "n_shared_experts": 2,
                 "intermediate_size": 10944, "vocab_size": 102400}
    assert {k: cfg[k] for k in published} == published
    assert cfg["reduced"] == ["num_hidden_layers"]
    assert cfg["num_hidden_layers"] == 5 and cfg["published"] == {
        "num_hidden_layers": 27}


def test_model_flops():
    """Per position: 5 layers of MLA projections (13,762,560 MACs) and
    causal L^2 products (16 x 320 x 256 / 2), the dense MLP (3 x 2,048 x
    10,944), 4 MoE layers of router, 6 routed and 2 shared experts of
    1,408: 416,677,888 MACs; 61.44 TFLOP a step of 96 x 256 positions."""
    with open(f"{common.BENCH_DIR}/configs/deepseek-v2-lite-5l-embed.json") as f:
        m = json.load(f)
    macs = (5 * (13_762_560 + 16 * 320 * 256 / 2) + 3 * 2048 * 10944
            + 4 * (2048 * 64 + 3 * 2048 * 1408 * 8))
    assert arith_mla_moe.active_macs(m, 256) == macs == 416_677_888
    assert arith_mla_moe.step_flops(m, 96, 256) == pytest.approx(6.1442e13,
                                                                 rel=1e-4)
    assert arith_mla_moe.experts_fwd_flops(m, 96, 256) == \
        96 * 256 * 6 * 3 * 2 * 2048 * 1408 * 4


def canned():
    """One 1,000 us step: the experts span launched 200 us of kernels, the
    route span 50, the attention span 100; two batch copies and one other
    host wait."""
    ops = [Op("tdrbench.window", 0.0, 1000.0, 0.0, -1),
           Op("tdrbench.step", 10.0, 990.0, 0.0, 0),
           Op("tdr_torch.train.forward", 20.0, 500.0, 350.0, 1),
           Op("tdr_torch.sync.batch_h2d", 25.0, 30.0, 0.0, 2),
           Op("tdr_torch.sync.batch_h2d", 30.0, 35.0, 0.0, 2),
           Op("tdr_torch.mla.attend", 40.0, 100.0, 100.0, 2),
           Op("tdr_torch.moe.route", 100.0, 150.0, 50.0, 2),
           Op("tdr_torch.sync.moe_counts", 120.0, 130.0, 0.0, 6),
           Op("tdr_torch.moe.experts", 150.0, 300.0, 200.0, 2)]
    return Trace(0.0, 1000.0, [], ops)


def read(name, inputs, trace=None):
    return common.load_module("metrics", name).read(
        trace or canned(), inputs)


def test_moe_readers():
    inputs = {"steps": 1, "step_flops": 1e9, "experts_fwd_flops": 1e8,
              "peak_flops": 1e12, "top_k": 6}
    # 1e9 FLOP in a 1 ms window at 1e12 FLOP/s
    assert read("train_mfu_pct", inputs) == pytest.approx(100.0)
    # 1e8 FLOP in the experts' 200 us at 1e12 FLOP/s: 1e8 / 2e8
    assert read("moe_experts_fwd_roofline_pct", inputs) == pytest.approx(50.0)
    assert read("moe_route_ms_per_step", inputs) == pytest.approx(0.05)
    assert read("mla_attend_ms_per_step", inputs) == pytest.approx(0.1)
    assert read("host_syncs_per_step.moe", inputs) == pytest.approx(3.0)
    empty = Trace(0.0, 1000.0, [], [Op("tdrbench.window", 0.0, 1000.0, 0.0,
                                       -1)])
    for name in ("moe_experts_fwd_roofline_pct", "moe_route_ms_per_step",
                 "mla_attend_ms_per_step", "host_syncs_per_step.moe"):
        assert read(name, inputs, empty) is None


def test_assignments_from_the_counters(monkeypatch):
    from tdr_torch.utils import trace

    monkeypatch.setattr(trace, "counters", {"moe.tokens": 1000,
                                            "moe.assignments": 5000})
    assert read("moe_assignments_pct", {"top_k": 6}) == pytest.approx(
        100 * 5000 / 6000)
    monkeypatch.setattr(trace, "counters", {})
    assert read("moe_assignments_pct", {"top_k": 6}) is None
