"""K2 (the fused Swin block, `swin_block_kernel`) against its roofline, %:
the least time of its launches in the profiled stretch (each the larger of
its operations over the bf16 peak and its bytes over the memory rate,
from the shapes) over the device time its kernels took there. Launches
are the program's `LAUNCHES["swin_block"]` over the stretch."""


def read(ctx):
    if ctx.get("kind") != "video":
        return None
    n = ctx["launches"].get("swin_block", 0)
    dev = sum(d for name, d in ctx["trace"]["device_by_name"].items()
              if "swin_block_kernel" in name)
    if not n or dev <= 0:
        return None
    k = ctx["k2_launch"]
    least = ctx["bound_s"](k["tokens"] * k["flops_per_token"],
                           k["tokens"] * k["stream_bytes_per_token"] + k["weight_bytes"])
    return 100.0 * n * least / dev
