"""The engine's encoder stages per restored frame, ms: the per-frame legs
(encoder of the frame and its two Richardson-Lucy passes) and the anchor
pyramids, `Inference.stage_seconds["legs"] + ["anchor"]`, over the window
outside its profiled stretch."""


def read(ctx):
    if ctx.get("kind") != "video" or not ctx["frames"]:
        return None
    s = ctx["stage_seconds"]
    return (s["legs"] + s["anchor"]) / ctx["frames"] * 1e3
