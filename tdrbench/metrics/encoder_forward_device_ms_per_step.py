"""encoder_forward_device_ms_per_step: device time of the kernels launched
under the program's ``tdr_torch.train.forward`` span (the batch's copy in,
the encoder's forward and the loss), per training step in the window.
The backward's kernels come from autograd's own thread, so no span of the
step's thread holds them."""


def read(trace, inputs):
    s = trace.op_device_s(["tdr_torch.train.forward"])
    return s * 1e3 / inputs["steps"] if inputs["steps"] and s > 0 else None
