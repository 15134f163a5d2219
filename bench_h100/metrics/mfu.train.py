"""Model operations of the window's train steps (forward and backward) at each
product's peak, over the window's time, in %."""

from bench_h100.lib import readers


def read(ctx):
    return readers.mfu(ctx, "train_step")
