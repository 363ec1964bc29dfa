"""The trainer's wait for its next batch, ms a step: the program's span
`loader.wait` around the consumer's get in `prefetch_to_device` (the
trainer's loop), host clock, in the profiled step."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("loader.wait")
