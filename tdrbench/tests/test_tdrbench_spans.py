"""The readers of the program's own spans and counters, on canned traces
against numbers worked by hand, and a traced CPU rehearsal of each cell
that checks which of them it reports."""

import pytest

import tdrbench.run as run
from tdrbench.harness import common
from tdrbench.harness.trace import Op, Trace
from tdrbench.tests import small

SEED = 2**31 + 12345


def empty():
    """A window with one harness call and no program span in it."""
    ops = [Op("tdrbench.window", 0.0, 1000.0, 0.0, -1),
           Op("tdrbench.call", 10.0, 990.0, 0.0, 0)]
    return Trace(0.0, 1000.0, [], ops)


def read(name, inputs, trace=None):
    return common.load_module("metrics", name).read(trace or empty(), inputs)


def program_spans():
    """A 995 us window [5, 1000] with two traced calls of the program's
    spans; a retrieve span before the window is left out.  Call 1 (retrieve 20-490, 470 us): group 10, tokenize 30, encode
    20, two query copies 10 and 6, score 180 holding a matrix product and
    an overflow read of 40, results 80, docid map 20.  Call 2 (retrieve
    605-695, 90 us): results 10."""
    o = lambda n, s, e, p, dev=0.0: Op(n, s, e, dev, p)  # noqa: E731
    ops = [o("tdrbench.window", 5.0, 1000.0, -1),
           o("tdrbench.call", 10.0, 500.0, 0),
           o("tdr_torch.router.retrieve", 20.0, 490.0, 1),
           o("tdr_torch.router.group", 25.0, 35.0, 2),
           o("tdr_torch.router.tokenize", 40.0, 70.0, 2),
           o("tdr_torch.sparse.encode", 80.0, 100.0, 2),
           o("tdr_torch.sync.queries_h2d", 100.0, 110.0, 2),
           o("tdr_torch.sync.queries_h2d", 110.0, 116.0, 2),
           o("tdr_torch.sparse.score", 120.0, 300.0, 2),
           o("aten::mm", 130.0, 150.0, 8),
           o("tdr_torch.sync.overflow", 250.0, 290.0, 8),
           o("aten::item", 255.0, 288.0, 10),
           o("tdr_torch.sync.results", 320.0, 400.0, 2),
           o("tdr_torch.router.map_docids", 410.0, 430.0, 2),
           o("tdrbench.call", 600.0, 700.0, 0),
           o("tdr_torch.router.retrieve", 605.0, 695.0, 14),
           o("tdr_torch.sync.results", 650.0, 660.0, 15),
           o("tdr_torch.router.retrieve", 0.0, 4.0, -1)]
    return Trace(5.0, 1000.0, [], ops)


def train_spans():
    """One step: the forward launched 60 us of kernels, its batch copy's 2
    included (a host op's device time holds its children's)."""
    ops = [Op("tdrbench.window", 0.0, 1000.0, 90.0, -1),
           Op("tdrbench.step", 10.0, 990.0, 90.0, 0),
           Op("tdr_torch.train.forward", 20.0, 400.0, 60.0, 1),
           Op("tdr_torch.sync.batch_h2d", 25.0, 30.0, 2.0, 2),
           Op("tdr_torch.train.backward", 400.0, 900.0, 0.0, 1)]
    return Trace(0.0, 1000.0, [], ops)


SPAN_READINGS = {
    # 5 sync spans (two query copies, the overflow read, two results
    # reads) over 2 retrieve spans in the window
    "host_syncs_per_call.sparse": 2.5,
    # (10 + 6 + 40 + 80 + 10) us over 4 queries
    "sync_wait_us_per_query.sparse": 36.5,
    "text_us_per_query.router": 7.5,
    "encode_us_per_query.sparse": 5.0,
    # score's 180 less the nested overflow read's 40 (the matrix product,
    # a torch op, stays)
    "dispatch_us_per_query.sparse": 35.0,
    # 470 + 90 less tokenize, encode, the copies, score (its overflow read
    # inside it once) and both results reads: 560 - 336; group and the
    # docid map stay
    "router_self_us_per_query": 56.0,
}


@pytest.mark.parametrize("name", sorted(SPAN_READINGS))
def test_program_span_readers(name):
    assert read(name, {"queries": 4}, program_spans()) == \
        pytest.approx(SPAN_READINGS[name])
    # a program without spans reads nothing
    assert read(name, {"queries": 4}) is None


def test_the_five_host_parts_add_up_to_the_calls():
    parts = [n for n in SPAN_READINGS if n != "host_syncs_per_call.sparse"]
    total = sum(read(n, {"queries": 4}, program_spans()) for n in parts)
    assert total == pytest.approx((470.0 + 90.0) / 4)


def test_forward_device_time_per_step():
    # the forward's 60 us (its copy's 2 inside it) over 2 steps
    assert read("encoder_forward_device_ms_per_step", {"steps": 2},
                train_spans()) == pytest.approx(0.03)
    assert read("encoder_forward_device_ms_per_step", {"steps": 2}) is None


def test_rows_useful_from_the_counters(monkeypatch):
    from tdr_torch.utils import trace

    name = "query_rows_useful_pct.sparse"
    monkeypatch.setattr(trace, "counters", {"router.rows_real": 2000,
                                            "router.rows_padded": 3328})
    assert read(name, {}) == pytest.approx(100.0 * 2000 / 3328)
    monkeypatch.setattr(trace, "counters", {})
    assert read(name, {}) is None


def test_idle_gaps_take_the_innermost_program_span():
    t = program_spans()
    t.kernels = [("k", 5.0, 95.0), ("k", 300.0, 140.0), ("k", 480.0, 520.0)]
    gaps = dict(t.breakdown()["idle_gaps"])
    # gaps [100, 300] and [440, 480]; midpoints 200 (score, around the
    # matrix product that ends at 150) and 460 (retrieve, between the
    # docid map and the end of the call)
    assert gaps == pytest.approx({"tdr_torch.sparse.score": 200e-6,
                                  "tdr_torch.router.retrieve": 40e-6})


# the per-layer metrics read from the program's own spans and counters that
# a traced CPU run gives (the train cell's forward span launches no device
# time here)
PROGRAM_READINGS = {
    "bm25-batch-docmix": {
        "host_syncs_per_call.sparse", "sync_wait_us_per_query.sparse",
        "text_us_per_query.router", "encode_us_per_query.sparse",
        "dispatch_us_per_query.sparse", "router_self_us_per_query",
        "query_rows_useful_pct.sparse"},
    "minilm6-train-b1024": set(),
}


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_a_traced_run_reports_the_program_readings(cell, monkeypatch):
    monkeypatch.setattr(run, "cell_files", small.cell_files)
    out = run.execute(cell, SEED, 1.0, True, device="cpu")
    assert out["correct"], out["checks"]
    assert PROGRAM_READINGS[cell] <= set(out["metrics"])
