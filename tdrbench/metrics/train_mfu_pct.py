"""train_mfu_pct: model FLOPs of the steps completed in the traced window
(``arith.encoder_step_flops``) over the window's seconds, as a share of the
bf16 dense peak (989 TFLOP/s at 700 W)."""


def read(trace, inputs):
    if not inputs["steps"] or trace.window_s <= 0:
        return None
    return 100.0 * inputs["step_flops"] * inputs["steps"] / (
        trace.window_s * inputs["peak_flops"])
