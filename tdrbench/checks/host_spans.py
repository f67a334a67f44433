#!/usr/bin/env python3
"""What the program's own spans say about the host, on the card, at a
cell's own size.

    python3 tdrbench/checks/host_spans.py --workload <cell> --seed <n> \
        [--syncs] [--traced-seconds 45]

``--syncs``: set-up as the cell's runs do, then one call (one set of
queries, or one train step) with ``torch.cuda.set_sync_debug_mode("warn")``
and no profiler: each warning is one host wait on the device, listed by the
program's line that waited.  Then the same call under ``torch.profiler``:
the ``tdr_torch.sync.*`` spans it opens, and every synchronizing CUDA
runtime call in it that no such span holds.  The spans name every wait
when the three counts agree and no runtime call is left outside.

``--traced-seconds``: one run as ``run.py --trace 1`` makes it, with the
trace kept: the result's per-layer metrics, the harness's call (or step)
spans in the traced part (their count and mean host time), the five host
parts of a call against the call's time per query, and the share of the
idle time that the harness's own call span still holds.  Time it in a
process of its own: after ``--syncs``' profiler session the same process
answered about a fifth fewer queries a second before its own trace began
(an H100, one seed, against a fresh process).

Prints one JSON line a part.  The benchmark's own runs do not run this.
"""

import argparse
import collections
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import tdrbench.run as run  # noqa: E402
from tdrbench.harness import common, spans  # noqa: E402
from tdrbench.harness import trace as tr  # noqa: E402

# the CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# the harness's span around the profiled call
ONCE = "tdrbench.once"
# per-layer metrics whose sum is the host time of a call, per query
PARTS = ("sync_wait_us_per_query.sparse", "text_us_per_query.router",
         "encode_us_per_query.sparse", "dispatch_us_per_query.sparse",
         "router_self_us_per_query")


def emit(part, **fields):
    print(json.dumps({"part": part, **fields}), flush=True)


def unspanned_syncs(trace):
    """The synchronizing runtime calls of the profiled call: the count that
    a ``tdr_torch.sync.*`` span holds, and the others by their chain of
    host ops."""
    held, loose = 0, collections.Counter()
    for op in trace.ops:
        if op.name not in SYNC_CALLS:
            continue
        chain, p = [], op.parent
        while p >= 0:
            chain.append(trace.ops[p].name)
            p = trace.ops[p].parent
        if ONCE not in chain:
            continue
        if any(n.startswith("tdr_torch.sync.") for n in chain):
            held += 1
        else:
            loose[" < ".join([op.name] + chain[:6])] += 1
    return held, dict(loose)


def sync_sites(workload: str, seed: int, device: str = "cuda"):
    import torch

    _, _, config, params = run.cell_files(workload)
    kind = common.load_module("traffic", params["kind"])
    r = kind.Run(config, params, seed, device)
    r.setup()
    if params["kind"] == "bm25_batch":
        once = lambda: r.call(r.sets[0])  # noqa: E731
    else:
        once = lambda: r.one_step(r.next_step)  # noqa: E731
    gpu = device != "cpu"
    if gpu:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        once()
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchronizing" in str(w.message))
    if gpu:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    tracing = tr.Tracing(True, 0.0, 0.0)
    tracing.due(0.0)
    with tr.span(ONCE):
        once()
    if gpu:
        torch.cuda.synchronize()
    trace = tr.from_profiler(tracing.stop())
    by_name = collections.Counter(trace.ops[i].name for i in
                                  spans.found(trace, "tdr_torch.sync.*"))
    held, loose = unspanned_syncs(trace)
    emit("syncs", workload=workload, seed=seed,
         warnings=sum(sites.values()), sites=dict(sites),
         sync_spans=sum(by_name.values()), spans=dict(by_name),
         runtime_syncs_in_spans=held, runtime_syncs_outside=loose)
    r.release()


def traced(workload: str, seed: int, seconds: float, device: str = "cuda"):
    held = {}
    read = tr.from_profiler

    def keep(prof, extra=None):
        held["trace"] = read(prof, extra)
        return held["trace"]

    tr.from_profiler = keep
    try:
        out = run.execute(workload, seed, seconds, True, device=device)
    finally:
        tr.from_profiler = read
    trace = held["trace"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    params = run.cell_files(workload)[3]
    step = "tdrbench.call" if params["kind"] == "bm25_batch" \
        else "tdrbench.step"
    ms = [(o.end_us - o.start_us) / 1e3 for o in trace.ops
          if o.name == step and trace.start_us <= o.start_us < trace.end_us]
    idle = trace.window_s - trace.busy_s()
    gaps = dict(out["breakdown"]["idle_gaps"])
    fields = dict(workload=workload, seed=seed, correct=out["correct"],
                  card=common.power_limit() if device != "cpu" else "cpu",
                  metrics=metrics, traced=len(ms),
                  traced_mean_ms=sum(ms) / len(ms) if ms else None,
                  idle_s=idle, idle_gaps=out["breakdown"]["idle_gaps"],
                  harness_span_idle_share=gaps.get(step, 0.0) / idle
                  if idle > 0 else None)
    if all(p in metrics for p in PARTS) and ms:
        queries = params["queries_per_call"] * len(ms)
        fields.update(parts_us_per_query=sum(metrics[p] for p in PARTS),
                      call_us_per_query=sum(ms) * 1e3 / queries)
    emit("traced", **fields)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--traced-seconds", type=float, default=0.0)
    args = ap.parse_args()
    print(f"card: {common.power_limit()}", flush=True)
    if args.syncs:
        sync_sites(args.workload, args.seed)
    if args.traced_seconds > 0:
        traced(args.workload, args.seed, args.traced_seconds)
    common.import_check("after the readings")


if __name__ == "__main__":
    main()
