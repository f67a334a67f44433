#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from for an
``mla_moe_train`` cell, on the card, at the cell's own size, as
``calibrate.py`` reads them for the other kinds.

    python3 tdrbench/checks/calibrate_mla_moe.py --workload <cell> \
        --seeds 1 2 3 ... [--control 2]

One process reads every seed in turn: set-up's first steps held to the
reference (``reference/mla_moe.py``); on the first ``--control`` seeds the
control, the reference in float8 put in the program's place, and each of
the kind's faults planted in the program (``Run.FAULTS``: the state left
unchanged, half the batch, one token altered, one expert a token fewer,
no shared experts, no YaRN mscale).  Prints one JSON line a reading
({"seed", "side", numbers}), then the largest sound reading and the
smallest control or fault reading of each number.  The benchmark's own
runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import tdrbench.run as run  # noqa: E402
from tdrbench.checks.calibrate import free  # noqa: E402
from tdrbench.harness import common  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=2,
                    help="read the control and the faults on the first N seeds")
    args = ap.parse_args()
    from tdrbench.reference import encoder as ref_enc

    _, _, config, params = run.cell_files(args.workload)
    kind = common.load_module("traffic", params["kind"])
    print(f"card: {common.power_limit()}", flush=True)
    sound, bad = {}, {}

    def emit(seed, side, checks, t0, into):
        row = {k: v for k, (v, _) in checks.items()}
        for k, v in row.items():
            into.setdefault(k, []).append((v, side, seed))
        print(json.dumps({"seed": seed, "side": side, **row,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = kind.Run(config, params, seed)
        r.setup()
        r.release()
        ref = r.readings()
        emit(seed, "program", r.check(ref), t0, sound)
        print(json.dumps({"seed": seed, "left out of change_gap": r.left_out,
                          "losses": r.first_losses,
                          "reference losses": ref["losses"]}), flush=True)
        if i < args.control:
            emit(seed, "control fp8 reference",
                 r.check(ref, r.readings(ref_enc.fp8)), t0, bad)
            for fault in kind.Run.FAULTS:
                f = kind.Run(config, params, seed, fault=fault)
                f.q_texts, f.p_texts, f.order = r.q_texts, r.p_texts, r.order
                f.setup()
                f.release()
                emit(seed, f"fault {fault}", f.check(ref), t0, bad)
                del f
                free()
        del r, ref
        free()
    print(json.dumps({"sound max": {k: max(v) for k, v in sound.items()},
                      "control and fault min": {k: min(v) for k, v in
                                                bad.items()}}), flush=True)
    common.import_check("after the readings")


if __name__ == "__main__":
    main()
