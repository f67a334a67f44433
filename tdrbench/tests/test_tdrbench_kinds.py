"""Each traffic kind rehearsed on the CPU through ``run.execute`` at a small
size (the look for a card skipped): a sound run comes out correct, with
and without the trace; a run with its timed path broken underneath comes
out not correct, once for each fault its cell can have; so does the
control (the program's int8 heads; the reference in float8) at the
committed limits."""

import sys
import types

import numpy as np
import pytest

import tdrbench.run as run
from tdrbench.harness import common
from tdrbench.tests import small

SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def small_cells(monkeypatch):
    monkeypatch.setattr(run, "cell_files", small.cell_files)


def execute(cell, trace=False):
    return run.execute(cell, SEED, 1.0, trace, device="cpu")


def plant(monkeypatch, broken):
    """Serve ``broken`` to ``run.execute`` as its kind's ``Run``."""
    load = common.load_module

    def load_broken(folder, name):
        mod = load(folder, name)
        if folder == "traffic":
            mod.Run = broken
        return mod

    monkeypatch.setattr(common, "load_module", load_broken)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_sound_run_is_correct(cell, trace):
    out = execute(cell, trace)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = common.benchmark()
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in common.metrics_of(bench, section, cell)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert "breakdown" in out and "busy_s" in out["device"]


def test_a_traced_run_traces_the_windows_last_seconds(monkeypatch):
    monkeypatch.setattr(run, "TRACE_S", 1.0)
    out = run.execute("bm25-batch-docmix", SEED, 6.0, True, device="cpu")
    assert out["correct"], out["checks"]
    # the traced part begins 5 s in; the call running at 6 s may overrun
    assert 0 < out["device"]["window_s"] < 4.0
    # the rate of the 5 s before it
    assert out["metrics"]["queries_per_s.untraced_part"]["value"] > 0


def bm25_fault(fault):
    kind = common.load_module("traffic", "bm25_batch")

    class Broken(kind.Run):
        def call(self, idx):
            docs, vals = super().call(idx)
            if fault == "half_left_out":
                docs = [d if i % 2 else [] for i, d in enumerate(docs)]
            elif fault == "answer_altered":
                d0 = docs[0]
                lang = self.pool_langs[idx[0]]
                other = next(x for x in self.corpus.docids[::-1]
                             if x.startswith(f"doc-{lang}-") and x not in d0)
                docs = [[other] + d0[1:]] + docs[1:]
            elif fault == "stale":
                if not hasattr(self, "_first"):
                    self._first = (docs, vals)
                docs, vals = self._first
            return docs, vals

    return Broken


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered",
                                   "stale"])
def test_bm25_faults_are_caught(fault, monkeypatch):
    plant(monkeypatch, bm25_fault(fault))
    out = execute("bm25-batch-docmix")
    assert not out["correct"], out["checks"]


def test_a_load_after_the_window_gives_no_result(monkeypatch):
    """JAX loaded by the check, after the window: the run gives no
    result."""
    kind = common.load_module("traffic", "bm25_batch")

    class LoadsJax(kind.Run):
        def check(self, answers=None):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return super().check(answers)

    plant(monkeypatch, LoadsJax)
    with pytest.raises(common.BenchError, match="before the result"):
        execute("bm25-batch-docmix")


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "token_altered"])
def test_train_faults_are_caught(fault, monkeypatch):
    kind = common.load_module("traffic", "contrastive_train")

    class Broken(kind.Run):
        def __init__(self, *a):
            super().__init__(*a, fault=fault)

    plant(monkeypatch, Broken)
    out = execute("minilm6-train-b1024")
    assert not out["correct"], out["checks"]


def test_bm25_control_fails():
    """The program's own int8-head path answering the same sets."""
    kind = common.load_module("traffic", "bm25_batch")
    _, _, cfg, params = small.cell_files("bm25-batch-docmix")
    r = kind.Run(cfg, params, SEED, "cpu")
    r.setup()
    r.window(1.0)
    r.release()
    assert all(v <= lim for v, lim in r.check().values())
    ctl = kind.Run(cfg, params, SEED, "cpu", head_dtype="int8")
    ctl.corpus, ctl.pool_texts, ctl.pool_langs = (r.corpus, r.pool_texts,
                                                  r.pool_langs)
    ctl.build()
    checks = r.check({c: ctl.call(r.sets[r.calls[c]]) for c in r.kept})
    assert any(v > lim for v, lim in checks.values()), checks


def test_train_control_fails():
    """The reference in float8 in the program's place."""
    from tdrbench.reference import encoder as ref_enc

    kind = common.load_module("traffic", "contrastive_train")
    _, _, cfg, params = small.cell_files("minilm6-train-b1024")
    r = kind.Run(cfg, params, SEED, "cpu")
    r.setup()
    r.window(0.5)
    r.release()
    ref = r.readings()
    assert all(v <= lim for v, lim in r.check(ref).values())
    checks = r.check(ref, r.readings(ref_enc.fp8))
    assert any(v > lim for v, lim in checks.values()), checks


def test_every_set_holds_the_same_language_counts():
    kind = common.load_module("traffic", "bm25_batch")
    _, _, cfg, params = small.cell_files("bm25-batch-docmix")
    # a pool large enough to hold 200 / 7 queries of ko, its rarest language
    r = kind.Run(cfg, dict(params, pool=2000), SEED, "cpu")
    r.make_inputs()
    counts = {tuple(np.unique([r.pool_langs[i] for i in s],
                              return_counts=True)[1])
              for s in r.warm_sets + r.sets}
    assert len(counts) == 1 and sum(next(iter(counts))) == 200
    (c,) = counts
    assert max(c) > 20 * min(c) / 2      # en's share dwarfs ko's
    assert all(len(set(s)) == len(s) for s in r.sets)
