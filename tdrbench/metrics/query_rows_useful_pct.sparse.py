"""query_rows_useful_pct.sparse: the share of the rows scored that hold a
real query: the program's counters ``router.rows_real`` over
``router.rows_padded`` (each batch padded to its bucket), which count only
while a profiler records, so over the traced part of the window."""


def read(trace, inputs):
    try:
        from tdr_torch.utils.trace import counters
    except ImportError:          # a program without counters
        return None
    padded = counters.get("router.rows_padded", 0)
    return 100.0 * counters.get("router.rows_real", 0) / padded if padded \
        else None
