"""SPEINet's legs in the train step, device ms a step: the program's span
`model.legs` inside `SPEINet._forward` (the Richardson-Lucy legs and the
stacked encoder, forward only, one a step): the card's stream time
between the span's two events, idle inside included, in the profiled
step. None for a program without the span."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("model.legs", device=True)
