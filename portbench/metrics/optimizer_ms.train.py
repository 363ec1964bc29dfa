"""The train step's optimizer, device ms a step: the program's span
`train.optimizer` in `train_step` (Adam's `optimizer.step()`): the card's
stream time between the span's two events, idle inside included, in the
profiled step."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("train.optimizer", device=True)
