"""The whole engine's share of the card's bf16 peak, %: the model FLOPs of
the windows restored in the profiled stretch (counted over the frozen
reference: each frame's legs, each window's restore in its routing, each
distinct anchor once) over the profiled stretch's length, over 989 TFLOP/s."""

PEAK = 989e12


def read(ctx):
    if ctx.get("kind") != "video" or not ctx["traced_frames"]:
        return None
    return 100.0 * ctx["model_flops"] / ctx["trace"]["window_s"] / PEAK
