"""Share of the profiled stretch of a video window in which no operation
ran on the card, %: wall time less the union of device intervals."""


def read(ctx):
    if ctx.get("kind") != "video" or ctx["trace"]["window_s"] <= 0:
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
