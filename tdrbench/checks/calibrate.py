#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card, at the
cell's own size: the program's numbers over many seeds, the control's on
some of them, and, for a training cell, each planted fault's.

    python3 tdrbench/checks/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--seconds 2]

One process reads every seed in turn.  ``bm25_batch`` cells: set-up and a
short window at the cell's load, the window's checked sets held to the
reference, then (on the first ``--control`` seeds) the program rebuilt
with its int8 heads answering the same sets.  ``contrastive_train`` cells:
set-up's first steps held to the reference; the control is the reference
in float8 put in the program's place; each of the kind's faults planted in
the program.  Prints one JSON line a reading: {"seed", "side", numbers}.
The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import tdrbench.run as run  # noqa: E402
from tdrbench.harness import common  # noqa: E402


def emit(seed, side, checks, t0):
    print(json.dumps({"seed": seed, "side": side,
                      **{k: v for k, (v, _) in checks.items()},
                      "s": round(time.perf_counter() - t0, 1)}), flush=True)


def free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def bm25(kind, config, params, seed, seconds, control):
    t0 = time.perf_counter()
    r = kind.Run(config, params, seed)
    r.setup()
    r.window(seconds)
    r.release()
    emit(seed, "program", r.check(), t0)
    if control:
        ctl = kind.Run(config, params, seed, head_dtype="int8")
        ctl.corpus, ctl.pool_texts, ctl.pool_langs = (r.corpus, r.pool_texts,
                                                      r.pool_langs)
        ctl.build()
        answers = {c: ctl.call(r.sets[r.calls[c]]) for c in r.kept}
        ctl.release()
        emit(seed, "control int8 heads", r.check(answers), t0)
    r._ref = None
    free()


def train(kind, config, params, seed, seconds, control):
    from tdrbench.reference import encoder as ref_enc

    t0 = time.perf_counter()
    r = kind.Run(config, params, seed)
    r.setup()
    r.release()
    ref = r.readings()
    emit(seed, "program", r.check(ref), t0)
    print(json.dumps({"seed": seed, "left out of change_gap": r.left_out}),
          flush=True)
    if control:
        emit(seed, "control fp8 reference", r.check(ref, r.readings(
            ref_enc.fp8)), t0)
        for fault in ("half_batch", "token_altered"):
            f = kind.Run(config, params, seed, fault=fault)
            f.setup()
            f.release()
            emit(seed, f"fault {fault}", f.check(ref), t0)
    free()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control (and faults) on the first N seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    _, _, config, params = run.cell_files(args.workload)
    kind = common.load_module("traffic", params["kind"])
    drive = {"bm25_batch": bm25, "contrastive_train": train}[params["kind"]]
    print(f"card: {common.power_limit()}", flush=True)
    for i, seed in enumerate(args.seeds):
        drive(kind, config, params, seed, args.seconds, i < args.control)
    common.import_check("after the readings")


if __name__ == "__main__":
    main()
