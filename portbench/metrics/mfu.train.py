"""The training step's share of the card's bf16 peak, %: the FLOPs of the
reference's forward and backward at the cell's batch and patch (counted
over the frozen reference, recomputation not counted) times the profiled
steps, over the profiled stretch's length, over 989 TFLOP/s."""

PEAK = 989e12


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["traced_steps"]:
        return None
    return 100.0 * ctx["step_flops"] * ctx["traced_steps"] / ctx["trace"]["window_s"] / PEAK
