"""sort_topk_device_ms_per_kq: device time of the kernels that aten::sort
and aten::topk launch (their children's included, each counted once), per
1,000 queries answered in the window."""

from tdrbench.harness.readers import per_thousand


def read(trace, inputs):
    ms = trace.op_device_s(["aten::sort", "aten::topk"]) * 1e3
    return per_thousand(ms, inputs["queries"]) if ms > 0 else None
