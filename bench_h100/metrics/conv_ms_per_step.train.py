"""Device ms under aten::convolution and aten::convolution_backward per traced train step."""

from bench_h100.lib import readers


def read(ctx):
    return readers.op_ms_per_unit(ctx, ("aten::convolution", "aten::convolution_backward"))
