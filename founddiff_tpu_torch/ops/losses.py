"""Auxiliary losses (mirror of ``founddiff_tpu/ops/losses.py``; reference
src/util.py:293-530): the Sobel gradient loss, the BMC contrastive
regression loss and the db3 wavelet low/high split.

Plain PyTorch on tensors of any device; no kernel of the TPU package
computes them.  Images are NHWC for :func:`sobel` / :func:`grad_loss`; the
wavelet split works on the last two axes of any array (``[..., H, W]``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Daubechies-3 decomposition filters (pywt 'db3'); reconstruction reverses them
_DB3_DEC_LO = np.array(
    [0.03522629188210, -0.08544127388224, -0.13501102001039,
     0.45987750211933, 0.80689150931334, 0.33267055295096], dtype=np.float64)
_DB3_DEC_HI = np.array(
    [-0.33267055295096, 0.80689150931334, -0.45987750211933,
     -0.13501102001039, 0.08544127388224, 0.03522629188210], dtype=np.float64)
_DB3_REC_LO = _DB3_DEC_LO[::-1].copy()
_DB3_REC_HI = _DB3_DEC_HI[::-1].copy()

_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel(x: torch.Tensor, epsilon: float = 1e-4) -> torch.Tensor:
    """Sobel gradient magnitude of NHWC images (``SobelOperator``,
    src/util.py:498-519): kernels scaled by 1/4, zero 'same' padding,
    ``sqrt(gx^2 + gy^2 + epsilon)``."""
    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)

    def depthwise(k):
        w = torch.tensor(k, dtype=torch.float32, device=x.device) / 4.0
        w = w.to(x.dtype).expand(C, 1, 3, 3)
        return F.conv2d(xc, w, padding=1, groups=C)

    gx, gy = depthwise(_SOBEL_X), depthwise(_SOBEL_Y)
    return torch.sqrt(gx ** 2 + gy ** 2 + epsilon).permute(0, 2, 3, 1)


def grad_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the Sobel maps (``GradLoss``, src/util.py:522-530)."""
    return (sobel(target) - sobel(pred)).abs().mean()


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise distances of the rows of x [m, d] and y [n, d]
    (src/util.py:319-337)."""
    xx = (x ** 2).sum(dim=1, keepdim=True)
    yy = (y ** 2).sum(dim=1, keepdim=True).t()
    return torch.sqrt((xx + yy - 2.0 * x @ y.t()).clamp_min(1e-12))


def bmc_loss(pred: torch.Tensor, target: torch.Tensor, noise_var) -> torch.Tensor:
    """Balanced-MSE contrastive regression loss (src/util.py:304-316):
    ``pred`` / ``target`` [B, ...]; the scale ``2 * noise_var`` takes no
    gradient (the JAX ``stop_gradient``)."""
    b = pred.shape[0]
    logits = -0.5 * euclidean_dist(pred.reshape(b, -1), target.reshape(b, -1)) / noise_var
    loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
    scale = 2 * noise_var
    return loss * (scale.detach() if torch.is_tensor(scale) else scale)


def _wave_padding(h: int, w: int, filter_len: int = 6, level: int = 6):
    """The padding of ``apply_wave_padding`` (src/util.py:357-381)."""
    p = 2 ** level
    hh = (p - h % p) % p + filter_len * p
    ww = (p - w % p) % p + filter_len * p
    return (hh // 2, hh - hh // 2), (ww // 2, ww - ww // 2)


def _symmetric_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Indices of numpy's 'symmetric' padding of a length-n axis (the edge
    repeated, reflections continuing past n)."""
    i = torch.arange(-before, n + after, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _pad_symmetric(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    return x.index_select(dim, _symmetric_index(x.shape[dim], before, after, x.device))


def _filter(f: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(f, dtype=torch.float32, device=like.device)


def _convolve(x: torch.Tensor, f: torch.Tensor, full: bool) -> torch.Tensor:
    """``numpy.convolve(row, f, 'valid' | 'full')`` along the last axis."""
    rows = x.reshape(-1, 1, x.shape[-1])
    k = len(f)
    out = F.conv1d(rows, f.flip(0).view(1, 1, k), padding=k - 1 if full else 0)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _dwt_rows(x, lo, hi):
    """One DWT level along the last axis, pywt 'symmetric' mode: pad
    len(f) - 1 on both sides, convolve, keep the odd positions."""
    pad = len(lo) - 1
    xp = _pad_symmetric(x, -1, pad, pad)
    return _convolve(xp, lo, False)[..., 1::2], _convolve(xp, hi, False)[..., 1::2]


def _idwt_rows(a, d, lo, hi, out_len: int):
    """The inverse of :func:`_dwt_rows` with the reconstruction filters."""
    def up(c):
        z = c.new_zeros(*c.shape[:-1], 2 * c.shape[-1])
        z[..., ::2] = c
        return z

    rec = _convolve(up(a), lo, True) + _convolve(up(d), hi, True)
    start = len(lo) - 2
    return rec[..., start:start + out_len]


def _dwt2(x, lo, hi):
    """One 2-D level on [..., H, W] -> (LL, (LH, HL, HH))."""
    a, d = _dwt_rows(x, lo, hi)  # along W
    aa, ad = _dwt_rows(a.transpose(-1, -2), lo, hi)
    da, dd = _dwt_rows(d.transpose(-1, -2), lo, hi)
    t = lambda u: u.transpose(-1, -2)
    return t(aa), (t(ad), t(da), t(dd))


def _idwt2(ll, bands, lo, hi, shape):
    lh, hl, hh = bands
    H, W = shape
    t = lambda u: u.transpose(-1, -2)
    l_col = t(_idwt_rows(t(ll), t(lh), lo, hi, H))
    h_col = t(_idwt_rows(t(hl), t(hh), lo, hi, H))
    return _idwt_rows(l_col, h_col, lo, hi, W)


def wt_decomp(image: torch.Tensor, level: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``image`` [..., H, W] into (low, high) frequency parts with a db3
    DWT (``wt_decomp``, src/util.py:343-356): pad as ``apply_wave_padding``
    (symmetric), ``level`` 2-D levels, the approximation band zeroed, the
    high-pass rebuilt and cropped; low = image - high.  Any level and any
    side, a power of two or not."""
    lo, hi = _filter(_DB3_DEC_LO, image), _filter(_DB3_DEC_HI, image)
    rlo, rhi = _filter(_DB3_REC_LO, image), _filter(_DB3_REC_HI, image)
    h, w = image.shape[-2], image.shape[-1]
    (t, b), (l, r) = _wave_padding(h, w, 6, level)
    x = _pad_symmetric(_pad_symmetric(image, -2, t, b), -1, l, r).float()
    coeffs, shapes = [], []
    for _ in range(level):
        shapes.append((x.shape[-2], x.shape[-1]))
        x, bands = _dwt2(x, lo, hi)
        coeffs.append(bands)
    x = torch.zeros_like(x)  # the approximation band zeroed
    for bands, shp in zip(reversed(coeffs), reversed(shapes)):
        x = _idwt2(x, bands, rlo, rhi, shp)
    arr_h = x[..., t:t + h, l:l + w]
    return image - arr_h, arr_h


__all__ = ["bmc_loss", "euclidean_dist", "grad_loss", "sobel", "wt_decomp"]
