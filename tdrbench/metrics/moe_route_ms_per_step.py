"""moe_route_ms_per_step: device time of the kernels launched under the
program's ``tdr_torch.moe.route`` spans (the router's product and softmax,
the top-k, the counts, the sort and the permutation of the rows), per
training step in the window."""


def read(trace, inputs):
    s = trace.op_device_s(["tdr_torch.moe.route"])
    return s * 1e3 / inputs["steps"] if inputs["steps"] and s > 0 else None
