"""dispatch_us_per_query.sparse: self time of ``tdr_torch.sparse.score``
(issuing a batch's scoring ops; the host waits nested in it left out), per
query answered in the traced part of the window."""

from tdrbench.harness import spans

NAME = "tdr_torch.sparse.score"


def read(trace, inputs):
    return spans.per_query(spans.self_us(trace, NAME), inputs,
                           bool(spans.found(trace, NAME)))
