"""encode_us_per_query.sparse: host time of query encoding (token lists to
term ids and weights, ``tdr_torch.sparse.encode`` spans, one a batch), per
query answered in the traced part of the window."""

from tdrbench.harness import spans

NAME = "tdr_torch.sparse.encode"


def read(trace, inputs):
    return spans.per_query(spans.host_us(trace, NAME), inputs,
                           bool(spans.found(trace, NAME)))
