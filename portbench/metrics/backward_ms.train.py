"""The train step's backward, device ms a step: the program's span
`train.backward` in `train_step` (`total.backward()` and the gradients'
average over the group): the card's stream time between the span's two
events, idle inside included, in the profiled step."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("train.backward", device=True)
