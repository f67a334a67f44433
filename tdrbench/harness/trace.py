"""The traced run: ``torch.profiler`` over the measured window's last
seconds (``Tracing``), reduced to plain records that the per-layer readers
take (``tdrbench/metrics/``).

A ``Trace`` holds the window's bounds on the profiler's clock, every device
operation (kernels, copies and fills) with its start and length, and every
host op (torch ops, the harness's own spans and torch's user ranges such as
``Optimizer.step#AdamW.step``) with its interval, nesting and the device
time of the kernels it launched, its children's included."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW_SPAN = "tdrbench.window"
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class Op:
    name: str
    start_us: float
    end_us: float
    device_us: float          # kernels launched by it and by its children
    parent: int               # index into Trace.ops, -1 at the top
    thread: int = 0


@dataclass
class Trace:
    start_us: float
    end_us: float
    kernels: List[Tuple[str, float, float]]      # (name, start_us, dur_us)
    ops: List[Op]
    spans: Dict[str, float] = field(default_factory=dict)   # host seconds

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def launched(self) -> List[Tuple[str, float, float]]:
        """Kernels proper: device operations other than copies and fills."""
        return [k for k in self.kernels if not k[0].startswith(COPY_PREFIXES)]

    def busy_intervals(self) -> np.ndarray:
        """The union of the device operations' intervals inside the window,
        as sorted, disjoint (start, end) rows."""
        if not self.kernels:
            return np.zeros((0, 2))
        iv = np.array([(s, s + d) for _, s, d in self.kernels], np.float64)
        iv = np.clip(iv, self.start_us, self.end_us)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.array(out)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6 if len(iv) else 0.0

    def op_device_s(self, names: Sequence[str]) -> float:
        """Device seconds under the host ops named in ``names``, each op
        counted once even where one such op runs inside another."""
        want = set(names)
        total = 0.0
        for op in self.ops:
            if op.name not in want or not (
                    self.start_us <= op.start_us < self.end_us):
                continue
            p = op.parent
            while p >= 0 and self.ops[p].name not in want:
                p = self.ops[p].parent
            if p < 0:
                total += op.device_us
        return total * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        iv = self.busy_intervals()
        edges = np.concatenate([[self.start_us], iv.reshape(-1),
                                [self.end_us]]).reshape(-1, 2)
        return [(s, e) for s, e in edges if e > s]

    def label(self, at_us: np.ndarray) -> List[str]:
        """The innermost host op running at each instant (by thread, the
        deepest found); "no host op" where none is."""
        depth = np.full(len(self.ops), -1, np.int64)
        for i in range(len(self.ops)):
            chain = []
            while i >= 0 and depth[i] < 0:
                chain.append(i)
                i = self.ops[i].parent
            d = depth[i] if i >= 0 else -1
            for j in reversed(chain):
                d += 1
                depth[j] = d
        best = np.full(len(at_us), -1)
        names = np.array(["no host op"] * len(at_us), dtype=object)
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, op in enumerate(self.ops):
            groups.setdefault((op.thread, int(depth[i])), []).append(i)
        for (_, d), idx in groups.items():
            idx = sorted(idx, key=lambda i: self.ops[i].start_us)
            starts = np.array([self.ops[i].start_us for i in idx])
            ends = np.array([self.ops[i].end_us for i in idx])
            j = np.searchsorted(starts, at_us, side="right") - 1
            hit = (j >= 0) & (ends[np.clip(j, 0, None)] >= at_us) & (d > best)
            for k in np.nonzero(hit)[0]:
                names[k] = self.ops[idx[j[k]]].name
                best[k] = d
        return list(names)

    def breakdown(self, n: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, summed by name, and
        the idle time summed by the host op running in each gap."""
        by_name: Dict[str, float] = {}
        for name, _, dur in self.kernels:
            key = name[:160]
            by_name[key] = by_name.get(key, 0.0) + dur * 1e-6
        gaps = self.idle_gaps()
        mids = np.array([(s + e) / 2 for s, e in gaps])
        by_label: Dict[str, float] = {}
        for (s, e), lab in zip(gaps, self.label(mids) if len(gaps) else []):
            by_label[lab] = by_label.get(lab, 0.0) + (e - s) * 1e-6
        top = lambda d: [[k, v] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(by_name), "idle_gaps": top(by_label)}


def from_profiler(prof, spans: Optional[Dict[str, float]] = None) -> Trace:
    """The window's records from a finished ``torch.profiler.profile``, read
    from its raw events (``kineto_results``); the window is the host op
    ``WINDOW_SPAN`` that the harness opened.  A host op's parent is the
    innermost op of its thread that spans it; a kernel belongs to the host
    op it is linked to (its correlation)."""
    raw = prof.profiler.kineto_results.events()
    host, kernels = [], []
    for e in raw:
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if str(e.device_type()).endswith("CPU"):
            host.append((e.start_thread_id(), start, -end, e.name(),
                         e.correlation_id()))
        elif not e.is_user_annotation():
            kernels.append((e.name(), start, end - start,
                            e.linked_correlation_id(), e.correlation_id()))
    host.sort()
    ops: List[Op] = []
    by_corr: Dict[int, int] = {}
    stack: List[int] = []
    thread = None
    for tid, start, neg_end, name, corr in host:
        if tid != thread:
            stack, thread = [], tid
        while stack and ops[stack[-1]].end_us <= start:
            stack.pop()
        ops.append(Op(name, start, -neg_end, 0.0,
                      stack[-1] if stack else -1, tid))
        stack.append(len(ops) - 1)
        if corr > 0:
            by_corr[corr] = len(ops) - 1
    for _, _, dur, linked, corr in kernels:
        i = by_corr.get(linked, by_corr.get(corr, -1))
        if i >= 0:
            ops[i].device_us += dur
    for i in range(len(ops) - 1, -1, -1):          # children after parents
        if ops[i].parent >= 0:
            ops[ops[i].parent].device_us += ops[i].device_us
    window = next(((o.start_us, o.end_us) for o in ops
                   if o.name == WINDOW_SPAN), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    kept = [(n, s, d) for n, s, d, _, _ in kernels
            if s < window[1] and s + d > window[0]]
    return Trace(window[0], window[1], kept, ops, dict(spans or {}))


class Tracing:
    """The traced part of a window: with ``enabled``, ``torch.profiler``
    (host and device activity) and the harness's ``WINDOW_SPAN`` over the
    window's last ``last_s`` seconds, or all of a shorter window.  A kind's
    window loop asks ``due(elapsed_s)`` before each call or step; the
    harness calls ``stop()`` once the window has closed."""

    def __init__(self, enabled: bool, seconds: float, last_s: float):
        self.enabled = enabled
        self.start_at = max(seconds - last_s, 0.0)
        self.started = False
        self.prof = self.window = None

    def due(self, elapsed_s: float) -> bool:
        """Whether the traced part has begun, beginning it at its time."""
        if not self.started and elapsed_s >= self.start_at:
            self.started = True
            if self.enabled:
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.__enter__()
                self.window = torch.profiler.record_function(WINDOW_SPAN)
                self.window.__enter__()
        return self.started

    def stop(self):
        """Ends the traced part; returns the finished profiler, or None."""
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
        return self.prof


@contextlib.contextmanager
def span(name: str):
    """A host op of the harness's own, seen in the trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
