"""The train step's forward, device ms a step: the program's span
`model.forward` inside `SWINT.forward` (and `SPEINet.forward`): the
card's stream time between the span's two events, idle inside included,
in the profiled step."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("model.forward", device=True)
