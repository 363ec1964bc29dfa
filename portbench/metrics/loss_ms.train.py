"""The train step's loss, device ms a step: the program's span `train.loss`
in `train_step` (the loss computer's call): the card's stream time between
the span's two events, idle inside included, in the profiled step."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("train.loss", device=True)
