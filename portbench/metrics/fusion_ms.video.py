"""The restore's fusion per restored window, ms: the program's span
`restore.fusion` in `SPEINet._restore` (the Swin fusion of the
neighbours, K2 and K3, and the fusion 1x1 conv): the card's stream time
between the span's two events, idle inside included, over the windows,
in the profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    return per_unit("restore.fusion", device=True)
