"""The SS2D modules' least time from their shapes over their CUDA-event time,
forward and backward, in the span window's steps, in %."""

from bench_h100.lib import readers


def read(ctx):
    return readers.ss2d_roofline(ctx, ("forward", "backward"))
