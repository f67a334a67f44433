"""attention_kernel_rows_pct.train: the share of the query rows the
encoder's attention computed that went through the hand-written kernels:
the program's counters ``encoder.attn_rows_kernel`` over
``encoder.attn_rows`` (B x H x L a call), which count only while a
profiler records, so over the traced part of the window."""


def read(trace, inputs):
    try:
        from tdr_torch.utils.trace import counters
    except ImportError:          # a program without counters
        return None
    rows = counters.get("encoder.attn_rows", 0)
    return 100.0 * counters.get("encoder.attn_rows_kernel", 0) / rows \
        if rows else None
