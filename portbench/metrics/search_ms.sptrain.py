"""SPEINet's patch search in the train step, device ms a step: the
program's span `restore.search` inside `transfer` (the correlation and
its argmax, K5 in the train step's 'mixed' routing; forward only),
nested in `restore.transfer`: the card's stream time between the span's
two events, over the profiled steps (`model.forward`'s spans, one a
step). None for a program without the span."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("restore.search", per="model.forward", device=True)
