"""device_idle_pct.train: the share of the training window with no device
operation running (kernels, copies and fills, from the profiler)."""

from tdrbench.harness.readers import idle_pct


def read(trace, inputs):
    return idle_pct(trace)
