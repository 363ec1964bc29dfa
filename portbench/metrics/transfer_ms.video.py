"""The restore's transfer per restored window, ms: the program's span
`restore.transfer` in `SPEINet._restore` (the sharp search, K4 or K5,
and the texture transfer, K10): the card's stream time between the
span's two events, idle inside included, over the windows, in the
profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    return per_unit("restore.transfer", device=True)
