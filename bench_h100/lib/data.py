"""Seeded synthetic CT-like slices, made on the device.

A slice is a body ellipse with a few organ ellipses of other densities and
a smooth texture, in [0, 1]; its low-dose pair adds pixel noise.  One
generator on the device draws every value, so a seed gives the same
slices on every run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ellipses(gen, n, k, size, device, lo, hi, r_lo, r_hi, cx=None, cy=None):
    u = lambda *s: torch.rand(*s, generator=gen, device=device)
    ax = torch.linspace(-1, 1, size, device=device)
    yy, xx = ax[:, None], ax[None, :]
    cx = u(n, k, 1, 1) * 1.2 - 0.6 if cx is None else cx
    cy = u(n, k, 1, 1) * 1.2 - 0.6 if cy is None else cy
    rx = r_lo + (r_hi - r_lo) * u(n, k, 1, 1)
    ry = r_lo + (r_hi - r_lo) * u(n, k, 1, 1)
    val = lo + (hi - lo) * u(n, k, 1, 1)
    inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
    return (inside * val).sum(dim=1)


@torch.no_grad()
def ct_pairs(n: int, size: int, gen: torch.Generator, device, noise: float = 0.05):
    """(normal-dose, low-dose) slices [n, size, size, 1] in [0, 1]."""
    body = _ellipses(gen, n, 1, size, device, 0.35, 0.45, 0.75, 0.95,
                     cx=torch.zeros(n, 1, 1, 1, device=device),
                     cy=torch.zeros(n, 1, 1, 1, device=device))
    organs = _ellipses(gen, n, 6, size, device, -0.15, 0.35, 0.08, 0.35)
    texture = torch.randn(n, 1, 16, 16, generator=gen, device=device)
    texture = F.interpolate(texture, size=(size, size), mode="bilinear", align_corners=False)
    gt = (body + (body > 0) * organs + 0.04 * texture[:, 0]).clamp(0, 1)
    ld = (gt + noise * torch.randn(gt.shape, generator=gen, device=device)).clamp(0, 1)
    return gt[..., None].contiguous(), ld[..., None].contiguous()
