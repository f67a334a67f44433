"""host_syncs_per_call.sparse: the program's ``tdr_torch.sync.*`` spans
(each one host wait on the device: a copy from pageable memory, a flag or
the results read back) per ``tdr_torch.router.retrieve`` span, a call."""

from tdrbench.harness import spans


def read(trace, inputs):
    calls = len(spans.found(trace, "tdr_torch.router.retrieve"))
    return len(spans.found(trace, "tdr_torch.sync.*")) / calls if calls \
        else None
