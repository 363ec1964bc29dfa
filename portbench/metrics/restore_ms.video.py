"""The engine's restore stage (Swin fusion, search and transfer, decoder)
per restored frame, ms: `Inference.stage_seconds["restore"]`, host clock
around work that ends in the engine's own device sync, over the window
outside its profiled stretch."""


def read(ctx):
    if ctx.get("kind") != "video" or not ctx["frames"]:
        return None
    return ctx["stage_seconds"]["restore"] / ctx["frames"] * 1e3
