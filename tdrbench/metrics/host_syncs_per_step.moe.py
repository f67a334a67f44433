"""host_syncs_per_step.moe: the program's ``tdr_torch.sync.*`` spans (each
one host wait on the device) per training step in the traced window: the
batch's two copies in, and any wait of the MoE layers.  None where the
window holds no ``tdr_torch.train.forward`` span (a program without
spans)."""

from tdrbench.harness import spans


def read(trace, inputs):
    if not inputs["steps"] or not spans.found(trace, "tdr_torch.train.forward"):
        return None
    return len(spans.found(trace, "tdr_torch.sync.*")) / inputs["steps"]
