"""moe_assignments_pct: the (token, expert) pairs the routed products
computed, as a share of top-k times the positions that entered the MoE
layers: 100 x the program's counters ``moe.assignments`` over top-k x
``moe.tokens``, which count only while a profiler records, so over the
traced part of the window.  100 where no token is dropped."""


def read(trace, inputs):
    try:
        from tdr_torch.utils.trace import counters
    except ImportError:          # a program without counters
        return None
    tokens = counters.get("moe.tokens", 0)
    return (100.0 * counters.get("moe.assignments", 0)
            / (inputs["top_k"] * tokens) if tokens else None)
