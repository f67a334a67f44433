"""adamw_kernel_params_pct.train: the share of the parameters the train
step's AdamW updated that went through the hand-written kernel: the
program's counters ``adamw.params_kernel`` over ``adamw.params``, which
count only while a profiler records, so over the traced part of the
window."""


def read(trace, inputs):
    try:
        from tdr_torch.utils.trace import counters
    except ImportError:          # a program without counters
        return None
    n = counters.get("adamw.params", 0)
    return 100.0 * counters.get("adamw.params_kernel", 0) / n if n else None
