"""One batch from the loader, ms: the program's span `loader.batch` in the
producer thread of `prefetch_to_device` (the batch iterator's next(): its
thread pool's crops and augments, the stacks; then the upload), host
clock, spans that began and ended in the profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return per_unit("loader.batch")
