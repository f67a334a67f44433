"""moe_experts_fwd_roofline_pct: the routed experts' forward FLOPs
(``arith_mla_moe.experts_fwd_flops``, whatever computes them) of the steps
in the traced window over the device time of the kernels launched under
the program's ``tdr_torch.moe.experts`` spans (the grouped products, the
gate and the weighted combine), as a share of the bf16 dense peak.  The
backward's kernels come from autograd's own thread, outside the span."""


def read(trace, inputs):
    s = trace.op_device_s(["tdr_torch.moe.experts"])
    if not inputs["steps"] or s <= 0:
        return None
    return 100.0 * inputs["experts_fwd_flops"] * inputs["steps"] / (
        s * inputs["peak_flops"])
