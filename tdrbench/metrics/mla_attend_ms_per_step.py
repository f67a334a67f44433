"""mla_attend_ms_per_step: device time of the kernels launched under the
program's ``tdr_torch.mla.attend`` spans (latent attention from its
RMSNorm and projections through ``W_o``), per training step in the
window."""


def read(trace, inputs):
    s = trace.op_device_s(["tdr_torch.mla.attend"])
    return s * 1e3 / inputs["steps"] if inputs["steps"] and s > 0 else None
