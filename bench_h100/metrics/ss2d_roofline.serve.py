"""The SS2D modules' least time from their shapes over their CUDA-event time in
the span window's requests, in %."""

from bench_h100.lib import readers


def read(ctx):
    return readers.ss2d_roofline(ctx, ("forward",))
