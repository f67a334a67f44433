"""kernels_per_kq.sparse: device kernels launched in the window (copies
and fills left out), per 1,000 queries answered: a count."""

from tdrbench.harness.readers import per_thousand


def read(trace, inputs):
    n = len(trace.launched())
    return per_thousand(float(n), inputs["queries"]) if n else None
