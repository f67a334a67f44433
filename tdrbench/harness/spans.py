"""The program's own spans in a traced window: the ``tdr_torch.*`` host ops
that ``tdr_torch.utils.trace.annotate`` opens while a profiler records.  A
pattern names one span, or, ending in ``*``, every span whose name starts
with what comes before it.  Only spans that start inside the window count.
A program without such spans gives no match, and its readers no value."""

from __future__ import annotations

from typing import List, Sequence

PROGRAM = "tdr_torch."


def _match(name: str, pattern: str) -> bool:
    if pattern.endswith("*"):
        return name.startswith(pattern[:-1])
    return name == pattern


def _program(trace) -> List[int]:
    """Indices into ``trace.ops`` of the window's program spans (found once
    a trace: a traced window holds millions of torch ops)."""
    if getattr(trace, "_program_spans", None) is None:
        trace._program_spans = [
            i for i, op in enumerate(trace.ops)
            if op.name.startswith(PROGRAM)
            and trace.start_us <= op.start_us < trace.end_us]
    return trace._program_spans


def found(trace, pattern: str) -> List[int]:
    """Indices into ``trace.ops`` of the window's spans that match."""
    return [i for i in _program(trace) if _match(trace.ops[i].name, pattern)]


def _us(op) -> float:
    return op.end_us - op.start_us


def host_us(trace, pattern: str) -> float:
    """Summed host duration of the matching spans (one nested in another
    would count twice: no pattern the readers use matches spans that
    nest)."""
    return sum(_us(trace.ops[i]) for i in found(trace, pattern))


def self_us(trace, name: str, keep: Sequence[str] = ()) -> float:
    """Summed duration of the spans ``name``, less the part of each that
    nested program spans cover.  A nested span that matches a pattern of
    ``keep`` counts as the span's own time, as the host ops that are no
    program span do; a span nested in another nested one is covered by
    that one."""
    targets = set(found(trace, name))
    total = sum(_us(trace.ops[i]) for i in targets)

    def covers(i):
        return i not in targets and not any(
            _match(trace.ops[i].name, k) for k in keep)

    for j in _program(trace):
        if not covers(j):
            continue
        p = trace.ops[j].parent
        while p >= 0 and p not in targets:
            if trace.ops[p].name.startswith(PROGRAM) and covers(p):
                break                  # inside an outer covering span
            p = trace.ops[p].parent
        if p >= 0 and p in targets:
            total -= _us(trace.ops[j])
    return total


def per_query(us: float, inputs, matched: bool):
    """Microseconds a query answered in the traced part; None where the
    trace held no matching span or no query was answered."""
    n = inputs.get("queries")
    return us / n if matched and n else None
