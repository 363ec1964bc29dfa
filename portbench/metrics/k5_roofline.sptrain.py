"""K5 (`correlation_argmax_lds`, the kernel `corr_unfold_kernel`) in the
SPEINet train step against its roofline, %: the least time of its work in
the profiled stretch over the device time its kernels took there. The
work is that of the samples the program searched there (the `n` of its
`restore.search` spans), each a [D, L] query unfold against a [D, Lr]
reference: 2 L Lr D operations (PERF.md's count of K5) and the bytes of
its operands and results, at the cell's patch (L = Lr = (patch / 4)^2,
D = 9 x 4 n_feat). The least time is the larger of the operations over
the bf16 peak and the bytes over the memory rate. None for a program
without the span, or a stretch without the kernel."""

from portbench.harness.common import Manifest, bound_s

CONFIG = "speinet_reds"


def k5_work(samples: int, l: int, lr: int, d: int) -> tuple:
    """(operations, bytes) of K5 over `samples` searches: bf16 unfolds
    [D, L] and [D, Lr], f32 inverse norms [Lr], f32 scores and int32
    indices [L] a sample."""
    return (2.0 * samples * l * lr * d,
            float(samples) * (2 * d * l + 2 * d * lr + 4 * lr + 8 * l))


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    try:
        import speinet_tpu_torch.utils.spans as spans
    except ModuleNotFoundError:
        return None
    samples = sum(s.n for s in spans.recorded() if s.name == "restore.search")
    dev = sum(t for name, t in ctx["trace"]["device_by_name"].items()
              if "corr_unfold_kernel" in name)
    if not samples or dev <= 0:
        return None
    cfg = Manifest().config(CONFIG)
    l = (cfg["patch_size"] // 4) ** 2
    return 100.0 * bound_s(*k5_work(samples, l, l, 36 * cfg["n_feat"])) / dev
