"""device_idle_pct.sparse: the share of the sparse window with no device
operation running (kernels, copies and fills, from the profiler)."""

from tdrbench.harness.readers import idle_pct


def read(trace, inputs):
    return idle_pct(trace)
