"""Image quality metrics (mirror of ``founddiff_tpu/ops/metrics.py``;
reference src/util.py:188-236).

SSIM is kornia's: a normalised separable 11x11 gaussian window with sigma
1.5, reflect-padded 'same' filtering, the map clamped to [0, 1] before the
mean.  The window is a depthwise (grouped) ``F.conv2d``; everything runs on
the device of its inputs, in float32.  Images are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    """kornia-style normalized gaussian (centered)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_kernel2d(size: int, sigma: float) -> np.ndarray:
    k = gaussian_kernel1d(size, sigma)
    return np.outer(k, k).astype(np.float32)


def _filter2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' filter with reflect padding on NCHW input."""
    kh, kw = kernel.shape
    C = x.shape[1]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    return F.conv2d(x, kernel.expand(C, 1, kh, kw), groups=C)


def compute_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                 max_val: float = 1.0, reduction: str = "mean", full: bool = False):
    """SSIM on NHWC images (src/util.py:188-220).  ``reduction="none"``
    gives the NHWC map; ``full=True`` also returns the mean contrast-structure
    term ``cs``."""
    kernel = torch.from_numpy(gaussian_kernel2d(window_size, 1.5)).to(img1.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    img1 = img1.float().permute(0, 3, 1, 2)
    img2 = img2.float().permute(0, 3, 1, 2)

    mu1 = _filter2d(img1, kernel)
    mu2 = _filter2d(img2, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, kernel) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, kernel) - mu2_sq
    sigma12 = _filter2d(img1 * img2, kernel) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if reduction == "none":
        out = ssim_map.permute(0, 2, 3, 1)
    else:
        clamped = ssim_map.clamp(0.0, 1.0)
        out = clamped.mean() if reduction == "mean" else clamped.sum()
    if full:
        cs = ((2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)).mean()
        return out, cs
    return out


def compute_psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0):
    """src/util.py:223-232."""
    mse = (pred.float() - target.float()).square().mean()
    return 10.0 * torch.log10(max_val * max_val / mse)


def compute_rmse(pred: torch.Tensor, target: torch.Tensor):
    """src/util.py:235-236."""
    return (pred.float() - target.float()).square().mean().sqrt()


def slice_metrics(pred: torch.Tensor, target: torch.Tensor):
    """PSNR, SSIM and RMSE of one batch of slices (metrics.py:99-105)."""
    return {"psnr": compute_psnr(pred, target), "ssim": compute_ssim(pred, target),
            "rmse": compute_rmse(pred, target)}
