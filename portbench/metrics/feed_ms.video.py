"""The engine's feed per restored window, ms: the program's spans
`engine.feed_wait` (waits on the decode pool for frames and anchors) and
`engine.upload` (host-to-device copies), host clock, over the windows of
its `restore.fusion` spans (one a restore), in the profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    return per_unit(("engine.feed_wait", "engine.upload"), per="restore.fusion")
