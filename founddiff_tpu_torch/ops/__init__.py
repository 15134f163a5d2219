"""The port's ops (``founddiff_tpu/ops/__init__.py``).

Two JAX exports are functions named as modules of this package, and stay
in them so that ``from founddiff_tpu_torch.ops import flash_attention`` is
the module: ``ops.flash_attention.flash_attention`` and
``ops.selective_scan.selective_scan``.  ``selective_scan_pallas``, the TPU
kernel's entry, is ``ops.scan.selective_scan`` here.
"""

from founddiff_tpu_torch.ops.losses import bmc_loss, grad_loss, sobel, wt_decomp
from founddiff_tpu_torch.ops.metrics import (
    compute_psnr,
    compute_rmse,
    compute_ssim,
    slice_metrics,
)
from founddiff_tpu_torch.ops.selective_scan import (
    cross_merge_v0,
    cross_scan_v0,
    efficient_merge,
    efficient_scan,
    flops_selective_scan,
    selective_scan_chunked,
    selective_scan_ref,
)

__all__ = [
    "bmc_loss",
    "compute_psnr",
    "compute_rmse",
    "compute_ssim",
    "cross_merge_v0",
    "cross_scan_v0",
    "efficient_merge",
    "efficient_scan",
    "flops_selective_scan",
    "grad_loss",
    "selective_scan_chunked",
    "selective_scan_ref",
    "slice_metrics",
    "sobel",
    "wt_decomp",
]
