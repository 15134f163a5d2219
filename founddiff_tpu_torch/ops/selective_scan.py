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


def selective_scan_ref(u, delta, A, Bmat, Cmat, Dskip=None, delta_bias=None,
                       delta_softplus: bool = True, h_init=None,
                       return_last_state: bool = False):
    """The step-by-step reference (``selective_scan_ref``,
    selective_scan.py:67-100): the recurrence over L in fp32 from ``h_init``
    [B, K, D, N] (zeros by default); y [B, K, L, D] fp32, and with
    ``return_last_state`` the state after step L."""
    u, delta = u.float(), delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None, :]
    if delta_softplus:
        delta = F.softplus(delta)
    A, Bmat, Cmat = A.float(), Bmat.float(), Cmat.float()
    Bsz, K, L, D = u.shape
    h = (torch.zeros(Bsz, K, D, A.shape[-1], device=u.device) if h_init is None
         else h_init.float())
    ys = []
    for t in range(L):
        dt = delta[:, :, t, :, None]
        h = torch.exp(dt * A[None]) * h + (dt * u[:, :, t, :, None]) * Bmat[:, :, t, None, :]
        ys.append(torch.einsum("bkdn,bkn->bkd", h, Cmat[:, :, t]))
    y = torch.stack(ys, dim=2)
    if Dskip is not None:
        y = y + u * Dskip.float()[None, :, None, :]
    return (y, h) if return_last_state else y


def flops_selective_scan(B: int, L: int, D: int, N: int, with_D: bool = True,
                         with_Z: bool = False, with_group: bool = True,
                         with_complex: bool = False) -> int:
    """Static FLOP estimate of one selective scan (``flops_selective_scan_fn``,
    src/emamba2.py:38-110; selective_scan.py:199-219): 9 B L D N for the
    recurrence, plus B D L for the D skip and for the z gate."""
    if with_complex:
        raise ValueError("complex scans are not estimated")
    return 9 * B * L * D * N + (B * D * L if with_D else 0) + (B * D * L if with_Z else 0)


def selective_scan_chunked(u, delta, A, Bmat, Cmat, Dskip=None, delta_bias=None,
                           chunk: Optional[int] = None, return_bounds: bool = False,
                           return_last_state: bool = False):
    """Plain chunked scan, vectorised over the chunks of L.

    ``return_bounds`` also returns the state entering each chunk as
    ``h_bounds [B*K, NC, N, D]`` fp32, the layout the scan backward reads;
    ``return_last_state`` then (last) the state after step L, ``h_last
    [B, K, D, N]`` fp32 (the carry one chunk past the last; padded steps
    have delta' = 0 and pass the state through).

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
    out = (y,)
    if return_bounds:
        out += (entry.transpose(-1, -2).reshape(Bsz * K, NC, N, D),)
    if return_last_state:
        out += (carry,)
    return out if len(out) > 1 else y


def selective_scan(u, delta, A, Bmat, Cmat, Dskip=None, delta_bias=None,
                   return_last_state: bool = False):
    """The dispatching selective scan (``founddiff_tpu/ops/selective_scan.py``
    ``selective_scan``, :164-194): y [B, K, L, D] fp32, and with
    ``return_last_state`` ``(y, h_last [B, K, D, N] fp32)``.

    CUDA tensors take the kernel, ``scan_forward``, forward only (as the TPU
    path with the last state is: ``selective_scan_pallas``,
    scan_pallas.py:1188-1193; training takes
    :class:`founddiff_tpu_torch.ops.scan.SelectiveScanFn`).  CPU tensors
    take the plain chunked scan.  delta' is ``softplus(delta + delta_bias)``
    (the JAX ``delta_softplus=True``, the only value the port's callers
    pass).
    """
    K, D = A.shape[0], A.shape[1]
    if u.is_cuda:
        from founddiff_tpu_torch.ops.scan import scan_forward

        zeros = lambda: torch.zeros(K, D, device=u.device)
        y, _, *last = scan_forward(
            u.float(), delta.float(), A, Bmat.float(), Cmat.float(),
            zeros() if Dskip is None else Dskip, zeros() if delta_bias is None else delta_bias,
            last_state=return_last_state)
        return (y, last[0]) if return_last_state else y
    return selective_scan_chunked(u, delta, A, Bmat, Cmat, Dskip, delta_bias,
                                  return_last_state=return_last_state)


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


def cross_scan_v0(x: torch.Tensor) -> torch.Tensor:
    """The full four-direction layout of ``forward_corev0`` (reference
    src/emamba2.py:589-612): [row-major, column-major, reversed row-major,
    reversed column-major]; x [B, H, W, C] -> [B, 4, H*W, C]."""
    B, H, W, C = x.shape
    rows = x.reshape(B, H * W, C)
    cols = x.transpose(1, 2).reshape(B, H * W, C)
    return torch.stack([rows, cols, rows.flip(1), cols.flip(1)], dim=1)


def cross_merge_v0(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The inverse accumulate of :func:`cross_scan_v0` (src/emamba2.py:625-630):
    each direction un-flipped and un-transposed, the four summed;
    ys [B, 4, H*W, C] -> [B, H, W, C]."""
    B, K, L, C = ys.shape
    rows = ys[:, 0] + ys[:, 2].flip(1)
    cols = ys[:, 1] + ys[:, 3].flip(1)
    return rows.reshape(B, H, W, C) + cols.reshape(B, W, H, C).transpose(1, 2)


def efficient_merge(ys: torch.Tensor, ori_h: int, ori_w: int,
                    step_size: int = 2) -> torch.Tensor:
    """Inverse interleave (reference src/emamba2.py:236-263):
    out[2i,2j]=dir0, out[2i+1,2j]=dir1, out[2i,2j+1]=dir2, out[2i+1,2j+1]=dir3.

    The four directions fill a 2x2 block of each s x s cell; the JAX merge
    reshapes them to the whole cell, which fails for any step but 2
    (``efficient_merge``'s reshape, selective_scan.py:301): so does this
    one, with a ``TypeError`` as there."""
    B, K, L, C = ys.shape
    s = step_size
    if s != 2:
        raise TypeError(f"efficient_merge: 4 directions of {L} steps fill a 2x2 block of each "
                        f"{s}x{s} cell, not the cell (step_size {s}; the JAX merge fails "
                        "the same way)")
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
