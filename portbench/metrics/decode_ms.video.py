"""The restore's decoder per restored window, ms: the program's span
`restore.decode` in `SPEINet._restore` (the decoder with its texture
injection and refinement convs, K1): the card's stream time between the
span's two events, idle inside included, over the windows, in the
profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    return per_unit("restore.decode", device=True)
