"""sync_wait_us_per_query.sparse: host time inside the program's
``tdr_torch.sync.*`` spans (the host waiting on the device), per query
answered in the traced part of the window."""

from tdrbench.harness import spans


def read(trace, inputs):
    matched = bool(spans.found(trace, "tdr_torch.router.retrieve"))
    return spans.per_query(spans.host_us(trace, "tdr_torch.sync.*"), inputs,
                           matched)
