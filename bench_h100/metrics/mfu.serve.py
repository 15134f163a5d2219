"""Model operations of the window's requests at each product's peak, over the
window's time, in %."""

from bench_h100.lib import readers


def read(ctx):
    return readers.mfu(ctx, "founddiff_request")
