"""step_mfu: the whole step's share of the card's dense bf16 peak (989
TFLOP/s, H100 SXM data sheet), in %: the reference step's FLOPs at the
cell's shapes (counted on the meta device, so the count is the same
whatever implements the work) times the window's steps a second."""

PEAK_BF16_FLOPS = 989e12


def read(r):
    if not r.flops_per_step:
        return None
    rate = r.window_steps() / r.window_s()
    return 100.0 * r.flops_per_step * rate / PEAK_BF16_FLOPS
