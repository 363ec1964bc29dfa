"""Device ms per training step in kernels that are none of the port's
kernels, cuDNN convolutions or matmuls (elementwise ops, reductions,
copies: the step's glue), from the profiled steps."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["traced_steps"]:
        return None
    return ctx["trace"]["device_by_class"].get("elementwise", 0.0) / ctx["traced_steps"] * 1e3
