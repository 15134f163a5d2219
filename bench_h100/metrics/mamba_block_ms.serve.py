"""CUDA-event ms of every MambaBlock call per UNet forward in the span window."""

from bench_h100.lib import readers


def read(ctx):
    return readers.span_ms_per_forward(ctx, "MambaBlock")
