"""Host ms per batch handed to the trainer: the benchmark's span around
each next() on the loader (the program's batch iterator: crops, augments,
stacking on its thread pool), in the prefetch thread, over the window."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["next_s"]:
        return None
    return sum(ctx["next_s"]) / len(ctx["next_s"]) * 1e3
