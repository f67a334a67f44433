"""What every run shares: finding a cell's files by name, the import check,
the device record and the result line."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import sys
import types
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tdr"})
PROGRAM = "tdr_torch"


class BenchError(RuntimeError):
    """A run that cannot give a result: no line is printed, the exit code
    is not 0."""


def load_json(*parts: str) -> dict:
    path = os.path.join(BENCH_DIR, *parts)
    if not os.path.isfile(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``tdrbench/<folder>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    if not os.path.isfile(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"tdrbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise BenchError("BENCHMARK.json not found at the checkout's root")
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, section: str, cell: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list it
    under ``workloads``, and those with no ``workloads`` key."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if top(m) in FORBIDDEN)


def reference_leaks() -> List[str]:
    """Names of the program that the reference's modules hold or import:
    by their source (every import statement) and by what each loaded
    reference module holds."""
    found = []
    ref_dir = os.path.join(BENCH_DIR, "reference")
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            found += [f"reference/{fname} imports {n}" for n in names
                      if top(n) in FORBIDDEN | {PROGRAM}]
    for name, mod in list(sys.modules.items()):
        if not name.startswith("tdrbench.reference"):
            continue
        for attr, val in vars(mod).items():
            owner = (val.__name__ if isinstance(val, types.ModuleType)
                     else getattr(val, "__module__", None))
            if isinstance(owner, str) and top(owner) in FORBIDDEN | {PROGRAM}:
                found.append(f"{name}.{attr} is from {owner}")
    return found


def import_check(where: str) -> None:
    bad = forbidden_modules()
    leaks = reference_leaks()
    if bad or leaks:
        msg = (f"import check {where}: loaded {bad}" if bad else
               f"import check {where}: the reference reaches the program: "
               f"{leaks}")
        print(msg, file=sys.stderr, flush=True)
        raise BenchError(msg)


def device_record(chips: int, peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def host_state(card: bool = False) -> str:
    """The host's load and mean core clock, the cores this process may run
    on, its string-hash seed and torch's thread count (with ``card``, the
    card's clocks, temperature and power as ``nvidia-smi`` reads them), for
    the record of a run's noise."""
    import subprocess

    import torch

    def read(path, pick):
        try:
            with open(path) as f:
                return pick(f.read())
        except (OSError, ValueError):
            return "unknown"

    load = read("/proc/loadavg", lambda t: " ".join(t.split()[:3]))
    mhz = read("/proc/cpuinfo", lambda t: "%.0f" % (lambda v: sum(v) / len(v))(
        [float(l.split(":")[1]) for l in t.splitlines()
         if l.startswith("cpu MHz")]))
    out = (f"load {load}, cpu MHz {mhz}, cores "
           f"{len(os.sched_getaffinity(0))}, PYTHONHASHSEED "
           f"{os.environ.get('PYTHONHASHSEED')}, torch threads "
           f"{torch.get_num_threads()}")
    if card:
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "temperature.gpu,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30)
            out += f"; card {smi.stdout.strip()}"
        except (OSError, subprocess.SubprocessError):
            pass
    return out


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
