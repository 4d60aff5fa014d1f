"""The untraced window's share of the f32 peak, in %: the reference's
operations a step on one card (forward, loss and backward, counted by
FlopCounterMode at the cell's shapes) times the window's steps, over its
seconds and 67 TFLOP/s."""

PEAK_FLOPS_F32 = 67e12


def read(t):
    rate = t["flops_per_step"] * t["steps_untraced"] / t["seconds_untraced"]
    return 100.0 * rate / PEAK_FLOPS_F32
