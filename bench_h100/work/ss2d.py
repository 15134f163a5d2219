"""Least time of one SS2D module call (forward, or its backward) from its
shapes: x1 [B, H, W, C0], d_inner D, d_state N, dt_rank R.

Products: in_proj (C0 -> 2D), the delta/B/C projections (D -> R + 2N), the
dt projection (R -> D) and out_proj (D -> C0) per pixel, at the trunk's
product peak.  On the CUDA cores: the scan's recurrence (9 N + 1 per
channel and pixel) and the depthwise 3x3.  Bytes: x1 and the residual in,
the output out, each weight once; a backward reads the output's gradient
and x1 and writes both inputs' gradients and the weights' gradients, and
does twice the forward's operations.
"""

from bench_h100.lib import peaks


def least_seconds(meta: dict, phase: str) -> float:
    B, H, W, C0 = meta["shape"]
    D, N, R = meta["d_inner"], meta["d_state"], meta["dt_rank"]
    io = 2 if meta["dtype"] == "bfloat16" else 4
    P = B * H * W
    products = 2 * P * (C0 * 2 * D + D * (R + 2 * N) + R * D + D * C0)
    cores = P * D * (9 * N + 1) + 2 * P * D * 9
    weights = io * (C0 * 2 * D + 4 * (R + 2 * N) * D + 4 * D * R + D * C0 + 9 * D) \
        + 4 * (4 * D * N + 8 * D)
    moved = io * P * C0 * 3 + weights
    if phase == "backward":
        products, cores, moved = 2 * products, 2 * cores, io * P * C0 * 4 + 2 * weights
    return peaks.least_seconds(moved, [(products, peaks.PRODUCT_PEAK[meta["dtype"]]),
                                       (cores, peaks.FP32_FLOPS)])
