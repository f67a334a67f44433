"""router_self_us_per_query: the router's own Python, per query answered
in the traced part of the window: ``tdr_torch.router.retrieve`` less the
other layers' spans nested in it (tokenizing, encoding, dispatch, the host
waits); grouping, padding, the docid map and assembling the answers stay
(``tdr_torch.router.group`` and ``tdr_torch.router.map_docids`` are the
router's own)."""

from tdrbench.harness import spans

NAME = "tdr_torch.router.retrieve"
OWN = ("tdr_torch.router.group", "tdr_torch.router.map_docids")


def read(trace, inputs):
    us = spans.self_us(trace, NAME, keep=OWN)
    return spans.per_query(us, inputs, bool(spans.found(trace, NAME)))
