"""adamw_ms_per_step: device time of the kernels under torch's
``Optimizer.step#AdamW.step`` range, per training step in the window."""


def read(trace, inputs):
    s = trace.op_device_s(["Optimizer.step#AdamW.step"])
    return s * 1e3 / inputs["steps"] if inputs["steps"] and s > 0 else None
