"""``jax.image.resize`` for torch tensors, linear and cubic.

``jax.image.resize(x, shape, method)`` resamples each axis whose size
changes with the scale-and-translate weights of ``jax._src.image.scale``:
half-pixel centres, a triangle (linear) or Keys cubic kernel with a = -0.5
(cubic), widened by the inverse scale when the axis shrinks (antialias),
each output's weights renormalised over the input samples that exist, and
no clamping at the edges.  ``F.interpolate(mode="bicubic")`` has a = -0.75;
with ``antialias=True`` it has the a = -0.5 kernel but clamps the taps at the
edges.  Here each axis is one ``[in, out]`` weight matrix, built on the host
as JAX builds it, applied with one matmul an axis on ``x``'s device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_METHODS = {"linear": "linear", "bilinear": "linear", "cubic": "cubic", "bicubic": "cubic"}


def _kernel(x: np.ndarray, method: str) -> np.ndarray:
    """The kernel at float32 distances ``x``, each value rounded once."""
    x = x.astype(np.float64)
    if method == "linear":
        out = np.maximum(0.0, 1.0 - np.abs(x))
    else:
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        out = np.where(x >= 2.0, 0.0, out)
    return out.astype(np.float32)


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """JAX's ``compute_weight_mat`` for scale ``out / in`` and no
    translation, float32 ``[in_size, out_size]``: the sample positions and
    the kernel's polynomial rounded once each, as XLA's fused multiply-adds
    compute them under ``jit``."""
    method = _METHODS[method]
    f32 = np.float32
    # JAX's scale is a Python float, so 1 / scale is a double rounded once
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size) + 0.5) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _kernel(x, method)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``linear``/``bilinear`` and
    ``cubic``/``bicubic`` (antialiased when an axis shrinks), on ``x``'s
    device, in float32 or ``x``'s floating dtype."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has not the {x.ndim} axes of x")
    if method not in _METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    if not x.is_floating_point():
        x = x.float()
    for d, n in enumerate(shape):
        if x.shape[d] == n:
            continue
        w = torch.from_numpy(weight_matrix(x.shape[d], n, method)).to(x.device, x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
