"""encoder_nongemm_ms_per_step: device time of the kernels that are no
matrix product (``readers.GEMM`` names those that are), less the
optimizer's, per training step in the window."""

from tdrbench.harness.readers import GEMM

OPTIMIZER = ["Optimizer.step#AdamW.step", "Optimizer.zero_grad#AdamW.zero_grad"]


def read(trace, inputs):
    if not inputs["steps"]:
        return None
    other = sum(d for name, _, d in trace.launched()
                if not GEMM.search(name)) * 1e-6
    return (other - trace.op_device_s(OPTIMIZER)) * 1e3 / inputs["steps"]
