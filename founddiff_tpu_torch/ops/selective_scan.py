"""Selective scan and the EfficientScan/EfficientMerge layouts in PyTorch.

Mirror of ``founddiff_tpu/ops/selective_scan.py``.  Math (diagonal SSM, per
direction k and channel d, state size N):

    delta' = softplus(delta + delta_bias)
    h_t    = exp(delta'_t * A) * h_{t-1} + delta'_t * B_t * u_t
    y_t    = sum_n C_t[n] * h_t[:, n] + Dskip * u_t

Shapes: u, delta [B, K, L, D]; A [K, D, N]; Bmat, Cmat [B, K, L, N];
Dskip, delta_bias [K, D]; returns y [B, K, L, D] float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def selective_scan_chunked(u, delta, A, Bmat, Cmat, Dskip=None, delta_bias=None,
                           chunk: Optional[int] = None, return_bounds: bool = False):
    """Plain chunked scan, vectorised over the chunks of L.

    ``return_bounds`` also returns the state entering each chunk as
    ``h_bounds [B*K, NC, N, D]`` fp32, the layout the scan backward reads.

    Three passes, the same decomposition the CUDA scan uses:
      1. every chunk scans from a zero state (a loop over the ``chunk``
         positions, all chunks at once) and keeps its end state;
      2. a loop over chunks carries the entry states: ``H_{c+1} =
         exp(A * sum(delta'_c)) * H_c + h_end_c``;
      3. every chunk scans again from its entry state and emits y.
    Every exponent is ``delta' * A`` or ``A`` times a within-chunk sum of
    ``delta'`` (a difference of cumulative sums), never positive for A < 0.
    """
    Bsz, K, L, D = u.shape
    N = A.shape[-1]
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None, :]
    delta = F.softplus(delta)
    A = A.float()
    Bmat = Bmat.float()
    Cmat = Cmat.float()

    T = chunk or max(1, min(L, int(math.ceil(math.sqrt(L)))))
    pad = (-L) % T
    if pad:  # padded steps have delta' = 0 and u = 0: the state passes through
        padL = lambda x: F.pad(x, (0, 0, 0, pad))
        u_p, d_p, B_p, C_p = map(padL, (u, delta, Bmat, Cmat))
    else:
        u_p, d_p, B_p, C_p = u, delta, Bmat, Cmat
    NC = (L + pad) // T
    as_chunks = lambda x: x.reshape(Bsz, K, NC, T, x.shape[-1])
    u_c, d_c, B_c, C_c = map(as_chunks, (u_p, d_p, B_p, C_p))
    Ak = A[None, :, None]  # [1, K, 1, D, N]

    def step(h, t):
        dt = d_c[:, :, :, t, :, None]  # [B, K, NC, D, 1]
        bu = (d_c[:, :, :, t] * u_c[:, :, :, t])[..., None] * B_c[:, :, :, t, None, :]
        return torch.exp(dt * Ak) * h + bu

    h = torch.zeros(Bsz, K, NC, D, N, device=u.device)
    for t in range(T):
        h = step(h, t)
    decay = torch.exp(d_c.sum(dim=3)[..., None] * Ak)  # [B, K, NC, D, N]
    entry = torch.zeros_like(h)
    carry = torch.zeros(Bsz, K, D, N, device=u.device)
    for c in range(NC):
        entry[:, :, c] = carry
        carry = decay[:, :, c] * carry + h[:, :, c]
    y = torch.empty(Bsz, K, NC, T, D, device=u.device)
    h = entry
    for t in range(T):
        h = step(h, t)
        y[:, :, :, t] = torch.einsum("bkcdn,bkcn->bkcd", h, C_c[:, :, :, t])
    y = y.reshape(Bsz, K, NC * T, D)[:, :, :L]
    if Dskip is not None:
        y = y + u * Dskip.float()[None, :, None, :]
    if return_bounds:
        return y, entry.transpose(-1, -2).reshape(Bsz * K, NC, N, D)
    return y


def efficient_scan(x: torch.Tensor, step_size: int = 2) -> torch.Tensor:
    """NHWC image -> [B, 4, (H/s)(W/s), C] decimated direction sequences.

    Direction order (reference src/emamba2.py:206-212):
      0: (h even, w even) row-major      1: (w even, h odd) column-major
      2: (h even, w odd)  row-major      3: (w odd,  h odd) column-major
    """
    B, H, W, C = x.shape
    s = step_size
    pad_h, pad_w = (-H) % s, (-W) % s
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        H, W = H + pad_h, W + pad_w
    xr = x.reshape(B, H // s, s, W // s, s, C)
    d0 = xr[:, :, 0, :, 0]
    d2 = xr[:, :, 0, :, 1]
    d1 = xr[:, :, 1, :, 0].transpose(1, 2)
    d3 = xr[:, :, 1, :, 1].transpose(1, 2)
    flat = lambda d: d.reshape(B, -1, C)
    return torch.stack([flat(d0), flat(d1), flat(d2), flat(d3)], dim=1)


def efficient_merge(ys: torch.Tensor, ori_h: int, ori_w: int,
                    step_size: int = 2) -> torch.Tensor:
    """Inverse interleave (reference src/emamba2.py:236-263):
    out[2i,2j]=dir0, out[2i+1,2j]=dir1, out[2i,2j+1]=dir2, out[2i+1,2j+1]=dir3."""
    B, K, L, C = ys.shape
    s = step_size
    H = -(-ori_h // s)
    W = -(-ori_w // s)
    d0 = ys[:, 0].reshape(B, H, W, C)
    d1 = ys[:, 1].reshape(B, W, H, C).transpose(1, 2)
    d2 = ys[:, 2].reshape(B, H, W, C)
    d3 = ys[:, 3].reshape(B, W, H, C).transpose(1, 2)
    row_even = torch.stack([d0, d2], dim=3)
    row_odd = torch.stack([d1, d3], dim=3)
    y = torch.stack([row_even, row_odd], dim=2).reshape(B, H * s, W * s, C)
    return y[:, :ori_h, :ori_w]
