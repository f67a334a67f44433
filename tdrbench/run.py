#!/usr/bin/env python3
"""The benchmark of ``tdr_torch`` on NVIDIA GPUs.

    python3 tdrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration (``tdrbench/configs/``), its traffic
mix (``tdrbench/traffic/<mix>.json``, whose ``kind`` names the code that
runs it, ``tdrbench/traffic/<kind>.py``), its own file (``tdrbench/workloads/``,
which holds the limits of the comparison) and the readers of its per-layer
metrics (``tdrbench/metrics/<metric>.py``) are files of their own, so a new
cell, mix or metric needs no edit here.

A run makes its inputs from ``--seed``, builds and warms up the program
(set-up), measures for ``--seconds``, then checks what the window produced
against the plain reference (``tdrbench/reference/``).  With ``--trace 1``
the window's last ``TRACE_S`` seconds run under ``torch.profiler`` and the
result carries the per-layer metrics, read from them, instead of the
end-to-end ones.  The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers compared, each beside its limit.  Without a
CUDA device, with fewer devices than the cell asks for, or with JAX or the
JAX package loaded, it prints no result and exits with another code than 0.
"""

import os
import time

# the process's start on the host clock; a run that re-executes itself to
# fix its string hashes (``main``) carries the first start over
T_START = float(os.environ.get("TDRBENCH_START", time.time()))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tdrbench.harness import common  # noqa: E402
from tdrbench.harness.common import BenchError  # noqa: E402

# a traced run traces the window's last seconds: the profiler's own
# processing grows with what it records, and a run has 360 s in all; its
# start takes up to 8 s of this (the sparse cell, on an H100)
TRACE_S = 25.0


def cell_files(name: str):
    """(BENCHMARK.json entry, configuration, the kind's parameters) of a
    cell; the parameters are the mix's and the cell file's ``limits``."""
    bench = common.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    own = common.load_json("workloads", name + ".json")
    for key in ("config", "traffic", "chips"):
        if own.get(key) != cell[key]:
            raise BenchError(f"workloads/{name}.json says {key} "
                             f"{own.get(key)!r}, BENCHMARK.json {cell[key]!r}")
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    mix = common.load_json("traffic", cell["traffic"] + ".json")
    params = {**mix, "limits": own["limits"]}
    return bench, cell, config, params


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """One run; returns the result object.  On ``device="cpu"`` (a
    rehearsal at a small size) the look for CUDA devices is skipped."""
    import torch

    bench, cell, config, params = cell_files(workload)
    if device != "cpu":
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{torch.cuda.device_count()} CUDA devices, the "
                             f"cell asks for {cell['chips']}")
    from tdrbench.harness import trace as tr

    kind = common.load_module("traffic", params["kind"])
    run = kind.Run(config, params, seed, device)
    gpu = device != "cpu"
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    run.setup()
    if gpu:
        torch.cuda.synchronize()
    # what set-up made lives to the end: out of the collector's full passes
    gc.collect()
    gc.freeze()
    common.import_check("after set-up")
    setup_s = time.time() - T_START
    print("host before the window: " + common.host_state(), file=sys.stderr,
          flush=True)
    tracing = tr.Tracing(trace, seconds, TRACE_S)
    run.window(seconds, tracing)
    prof = tracing.stop()
    print("host after the window: " + common.host_state(card=gpu),
          file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated() if gpu else 0
    common.import_check("after the window")
    e2e = dict(run.end_to_end(), setup_s=setup_s)
    attempted, failed = run.attempted_failed()
    phases = {"set-up": setup_s, **getattr(run, "setup_parts", {}),
              "window": time.time() - T_START - setup_s}
    traced = None
    if trace:
        t0 = time.perf_counter()
        spans = {}
        if hasattr(run, "text_span"):
            spans["text_s_per_query"] = run.text_span()
        traced = tr.from_profiler(prof, spans)
        del prof
        phases["trace read"] = time.perf_counter() - t0
    run.release()
    gc.collect()
    t0 = time.perf_counter()
    checks = run.check()
    phases["check"] = time.perf_counter() - t0
    if getattr(run, "left_out", None):
        print(f"left out of change_gap (reference gradient under 1e-3 of "
              f"the median leaf's): {run.left_out}", file=sys.stderr)
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())

    if trace:
        inputs = run.layer_inputs()
        metrics = {}
        for m in common.metrics_of(bench, "per_layer", workload):
            value = common.load_module("metrics", m["name"]).read(traced,
                                                                  inputs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in common.metrics_of(bench, "end_to_end", workload)}
    dev = (common.device_record(cell["chips"], peak) if gpu else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    print("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)
    if hasattr(run, "diagnostics"):
        print("window: " + run.diagnostics(), file=sys.stderr, flush=True)
    if trace:
        dev["busy_s"] = traced.busy_s()
        dev["window_s"] = traced.window_s
        out["breakdown"] = traced.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    # the check, the trace's readers and the metrics' modules loaded since
    common.import_check("before the result")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    # the string hashes, and with them the order of every set and dict of
    # strings (the program numbers its terms in such an order), from the
    # seed: the same seed does the same work in every run
    hash_seed = str(args.seed % 2**32)
    if os.environ.get("PYTHONHASHSEED") != hash_seed:
        env = dict(os.environ, PYTHONHASHSEED=hash_seed,
                   TDRBENCH_START=repr(T_START))
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    try:
        out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    except BenchError as e:
        print(f"tdrbench: {e}", file=sys.stderr, flush=True)
        return 2
    card = common.power_limit()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
