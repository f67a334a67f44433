"""queries_per_s.untraced_part: queries answered over host seconds in the
part of a traced run's window before the profiler starts (its first
``run_seconds`` - ``TRACE_S``), where the window runs as an untraced
run's does: the closed loop's rate, whole calls and all their time."""


def read(trace, inputs):
    return inputs.get("queries_per_s_untraced")
