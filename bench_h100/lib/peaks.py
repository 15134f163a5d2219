"""Peak rates of one NVIDIA H100 SXM (data sheet, dense) and the least time
of a piece of work on it.

A product's operations count at the peak of the unit that takes them:
bf16 on the tensor cores; float32 as three TF32 products on the tensor
cores (the split the port's fp32 kernels use, about fp32's accuracy), so at
a third of the TF32 rate.  Float32 work that is no product (the scan's
recurrence, norms, the depthwise taps) counts at the CUDA cores' rate.  The
rates assume the card's full power limit of 700 W; ``nvidia-smi`` reads the
limit a card is set to, which the harness records beside each run.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 494.7e12
BF16_FLOPS = 989e12
FP32_PRODUCT_FLOPS = TF32_FLOPS / 3
FP32_FLOPS = 67e12

PRODUCT_PEAK = {"bfloat16": BF16_FLOPS, "float32": FP32_PRODUCT_FLOPS}


def least_seconds(nbytes: float, work) -> float:
    """``work``: ``[(operations, rate)]``.  Work on one unit adds up; the
    units and the memory run at once, so the least time is the largest of
    the bytes over the memory rate and each unit's operations over its
    rate (``chip_smoke.py`` ``bound_ms``, in seconds)."""
    per_unit = {}
    for n, rate in work:
        per_unit[rate] = per_unit.get(rate, 0.0) + n
    return max([nbytes / HBM_BYTES_PER_S] + [n / r for r, n in per_unit.items()])


def peak_seconds(work) -> float:
    """Σ operations / the peak of their unit: the time of ``work`` at 100% of
    each unit's peak, one after the other (the numerator of an mfu)."""
    return sum(n / rate for n, rate in work)
