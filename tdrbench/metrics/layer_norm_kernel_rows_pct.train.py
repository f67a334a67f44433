"""layer_norm_kernel_rows_pct.train: the share of the rows the encoder's
LayerNorms normalized that went through the hand-written kernels: the
program's counters ``encoder.ln_rows_kernel`` over ``encoder.ln_rows``,
which count only while a profiler records, so over the traced part of the
window."""


def read(trace, inputs):
    try:
        from tdr_torch.utils.trace import counters
    except ImportError:          # a program without counters
        return None
    rows = counters.get("encoder.ln_rows", 0)
    return 100.0 * counters.get("encoder.ln_rows_kernel", 0) / rows if rows \
        else None
