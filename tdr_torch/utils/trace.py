# Copied from tdr/utils/trace.py; device_trace/annotate map to torch.profiler.
"""Tracing / profiling utilities.

The reference's de-facto tracer is ``time.time()`` deltas + tqdm bars
(final_implementation.py:333-368; SURVEY.md §5 "Tracing / profiling").  Here:
a structured per-phase wall-clock tracer that nests, records a span tree, and
can emit `torch.profiler` traces for device phases.

The program's own spans and counters (``annotate``, ``count``) exist only
while a ``torch.profiler`` session records: a span is then a host op in
the same trace as the kernels, on the profiler's clock, and a counter adds.
With no profiler running, ``annotate`` hands back one shared null context
and ``count`` does nothing, so the hot paths pay a flag read for each.
Neither reads the device.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

log = logging.getLogger("tdr")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[tdr %(levelname).1s %(asctime)s] %(message)s", "%H:%M:%S"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


@dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    children: List["Span"] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seconds": round(self.seconds, 6),
            "meta": self.meta,
            "children": [c.to_dict() for c in self.children],
        }


class Tracer:
    """Nested wall-clock span tracer; one per pipeline run."""

    def __init__(self, name: str = "run"):
        self.root = Span(name, time.perf_counter())
        self._stack = [self.root]

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        s = Span(name, time.perf_counter(), meta=dict(meta))
        self._stack[-1].children.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self._stack.pop()
            log.debug("%s: %.3fs", name, s.seconds)

    def finish(self) -> dict:
        self.root.end = time.perf_counter()
        return self.root.to_dict()

    def report(self) -> str:
        self.root.end = self.root.end or time.perf_counter()
        lines: List[str] = []

        def walk(s: Span, depth: int):
            lines.append(f"{'  ' * depth}{s.name:<40s} {s.seconds * 1e3:10.1f} ms {s.meta or ''}")
            for c in s.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.finish(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace context for device phases; writes a Chrome
    trace (``trace.json``) into ``log_dir``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_profiling = torch.autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()

# the counters' totals over every part of the process a profiler recorded
counters: Dict[str, int] = {}


def annotate(name: str):
    """Named device-trace region: ``torch.profiler.record_function(name)``
    while a profiler records, else a shared null context (no host op, no
    cost beyond the check)."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``counters[name]`` while a profiler records; else does
    nothing.  ``n`` is a host number: a counter never reads the device."""
    if _profiling():
        counters[name] = counters.get(name, 0) + n


def reset_counters() -> None:
    counters.clear()


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[dict] = None):
    """Minimal standalone timer: ``with phase_timer('build', stats): ...``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        log.info("%s: %.3fs", name, dt)
