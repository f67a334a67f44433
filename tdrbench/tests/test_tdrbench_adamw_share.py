"""``adamw_kernel_params_pct.train``: its reader on the program's counters,
and a traced CPU rehearsal of the MiniLM train cell, whose CPU step
updates every parameter on torch's own path and none through the
kernel."""

import pytest

import tdrbench.run as run
from tdrbench.harness import common
from tdrbench.tests import small

SEED = 2**31 + 24680
NAME = "adamw_kernel_params_pct.train"


def read(inputs=None):
    return common.load_module("metrics", NAME).read(None, inputs or {})


def test_share_from_the_counters(monkeypatch):
    from tdr_torch.utils import trace

    monkeypatch.setattr(trace, "counters", {})
    assert read() is None                          # a program without them
    monkeypatch.setattr(trace, "counters", {"adamw.params": 29_896_704})
    assert read() == 0.0
    monkeypatch.setattr(trace, "counters", {"adamw.params": 2_000,
                                            "adamw.params_kernel": 1_500})
    assert read() == pytest.approx(75.0)
    monkeypatch.setattr(trace, "counters", {"adamw.params": 4_096,
                                            "adamw.params_kernel": 4_096})
    assert read() == 100.0


def test_the_train_cells_list_it():
    bench = common.benchmark()
    for cell in ("minilm6-train-b1024", "dsv2lite-embed-train-b48"):
        names = [m["name"] for m in common.metrics_of(bench, "per_layer",
                                                      cell)]
        assert NAME in names
    assert NAME not in [m["name"] for m in common.metrics_of(
        bench, "per_layer", "bm25-batch-docmix")]


def test_a_traced_cpu_run_counts_no_kernel(monkeypatch):
    from tdr_torch.utils import trace

    monkeypatch.setattr(run, "cell_files", small.cell_files)
    trace.reset_counters()
    out = run.execute("minilm6-train-b1024", SEED, 1.0, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 0.0
    assert trace.counters["adamw.params"] > 0
    trace.reset_counters()
