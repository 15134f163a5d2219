"""Share of the traced training window in which no operation ran on the card, in %."""

from bench_h100.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
