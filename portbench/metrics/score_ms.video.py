"""The engine's scoring per scored frame, ms: the program's span
`engine.score` around `Inference._score_chunk` (the chunk's uint8
readback, float64 PSNR and SSIM, the waits for the ground truth, the log
lines), host clock, over the frames it scored, in the profiled stretch."""

from portbench.harness.program_spans import per_unit


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    return per_unit("engine.score")
