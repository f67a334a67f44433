"""text_us_per_query.router: host time of the router's own tokenizing
(``tdr_torch.router.tokenize`` spans, one a language a call), per query
answered in the traced part of the window."""

from tdrbench.harness import spans

NAME = "tdr_torch.router.tokenize"


def read(trace, inputs):
    return spans.per_query(spans.host_us(trace, NAME), inputs,
                           bool(spans.found(trace, NAME)))
