"""The SPEINet training step's share of the card's bf16 peak, %, read as
`mfu.train` reads it: the FLOPs of the reference's forward and backward
at the cell's batch and patch times the profiled steps, over the
profiled stretch's length, over 989 TFLOP/s."""

from portbench.harness.common import load_reader


def read(ctx):
    return load_reader("mfu.train").read(ctx)
