"""Kernels run on the card per traced serving request."""

from bench_h100.lib import readers


def read(ctx):
    return readers.kernels_per_unit(ctx)
