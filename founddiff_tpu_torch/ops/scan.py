"""Selective scan with its backward, and the image-direct scan (the
counterpart of ``founddiff_tpu/ops/scan_pallas.py``).

Four kernels, each with its plain PyTorch version beside it:

- ``scan_forward`` replaces ``_scan_kernel`` (scan_pallas.py:269): the scan
  of [B, K, L, D] direction sequences, which also returns ``h_bounds
  [B*K, NC, N, D]``, the state entering each chunk of :func:`scan_chunk`
  steps;
- ``scan_backward`` replaces ``_scan_bwd_kernel`` (:415): the seven
  gradients from a replay of each chunk and the adjoint recurrence;
- ``scan_fused_forward`` replaces ``_scan_kernel_fused`` (:630): the scan of
  [B, 4, L, D] sequences with the delta/B/C projections inside, returning
  the same ``h_bounds`` as ``scan_forward``;
- ``scan_image_forward`` replaces ``_scan_kernel_image`` (:895): the four
  step-2 decimated direction scans straight from an NHWC image, with the
  delta/B/C projections inside.

CUDA tensors go to ``csrc/scan.cu`` and ``csrc/scan_image.cu``; CPU tensors to
the plain versions.  :class:`SelectiveScanFn`, :class:`SelectiveScanFusedFn`
and :class:`ScanImageFn` are the ``custom_vjp``s of ``selective_scan_pallas``
(:1141-1174), ``_selective_scan_pallas_fused`` (:784-814) and
``_scan_image`` (:1032-1098).  Math (per direction k, channel d, state n):

    delta' = softplus(delta + delta_bias)
    h_t    = exp(delta'_t * A) * h_{t-1} + delta'_t * B_t * u_t
    y_t    = sum_n C_t[n] * h_t[:, n] + Dskip * u_t

Dtypes as on the TPU: u, delta, B, C, y and their gradients at the io dtype
(that of u); A, Dskip, delta_bias, h_bounds and their gradients fp32; the
recurrence in fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.selective_scan import (
    efficient_merge,
    efficient_scan,
    selective_scan_chunked,
)

# The state sizes the kernels that hold the states in registers as a
# template argument are built for (the fused-projection and image scans,
# the fused block, the unified op).  Another N <= 64 is padded up to the next
# (:func:`pad_states`), a larger one to a multiple of 64 that runs in groups
# of 64.  scan_forward and scan_backward take any N as it is.
_STATE_SIZES = (4, 8, 16, 32, 64)
_GROUP = 64
_IMAGE_CHUNK = 128  # scan chunk of the image scan's plain version (as csrc/ss2d_block.cu)


def kernel_states(N: int) -> int:
    """The state count the register-resident kernels run N at."""
    return next((s for s in _STATE_SIZES if N <= s), -(-N // _GROUP) * _GROUP)


def pad_states(A, *cols):
    """A [..., N] and each of cols [..., N] (B or C, or the weights that
    project them) padded to :func:`kernel_states` (N) states: A with -1, cols
    with zeros.  A padded state starts at 0, receives delta' * 0 * u and
    stays 0, and C = 0 adds nothing to y: the same scan."""
    N = A.shape[-1]
    Np = kernel_states(N)
    if Np == N:
        return (A, *cols)
    return (F.pad(A, (0, Np - N), value=-1.0), *(F.pad(c, (0, Np - N)) for c in cols))


def scan_chunk(d_state: int) -> int:
    """Steps per chunk of ``scan_forward``/``scan_backward`` and of the
    ``h_bounds`` they share with ``scan_fused_forward``: chunk * N is held
    at 256, 64 steps at N = 4 down to an 8-step floor from N = 32 (the
    backward's per-chunk work holds a chunk's sub-tile states in registers
    and the state at each sub-tile's start in shared memory)."""
    return max(8, min(64, 256 // d_state))


# --- plain versions ----------------------------------------------------------


def scan_forward_plain(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk: int):
    """Plain version of ``scan_forward``: ``(y [B,K,L,D] io, h_bounds)``."""
    y, hb = selective_scan_chunked(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk=chunk,
                                   return_bounds=True)
    return y.to(u.dtype), hb


def scan_backward_plain(u, delta, A, Bmat, Cmat, Dskip, delta_bias, h_bounds, dy,
                        chunk: int):
    """Plain version of ``scan_backward``: an explicit chunked adjoint.

    Every chunk replays its states from ``h_bounds``; the adjoint
    ``gh_t = C_t dy_t + abar_{t+1} gh_{t+1}`` runs right to left in each chunk
    from a zero carry, a loop over chunks carries ``abar_first * gh_first``
    leftwards (``z_{c-1} = exp(A * sum(delta'_c)) z_c + local_c``), and a
    second right-to-left pass forms the gradients.  Returns
    ``(gu, gdelta, gA, gB, gC, gDskip, gdelta_bias)``.
    """
    Bsz, K, L, D = u.shape
    N = A.shape[-1]
    T = chunk
    NC = -(-L // T)
    pad = NC * T - L
    f32 = lambda t: t.float()
    raw = f32(delta) + f32(delta_bias)[None, :, None, :]
    dl = F.softplus(raw)

    def chunks(x):  # [B, K, L, F] -> [B, K, NC, T, F], padded steps 0
        return F.pad(x, (0, 0, 0, pad)).reshape(Bsz, K, NC, T, x.shape[-1])

    u_c, dl_c, raw_c, dy_c = map(chunks, (f32(u), dl, raw, f32(dy)))
    B_c, C_c = chunks(f32(Bmat)), chunks(f32(Cmat))
    Ak = f32(A)[None, :, None]  # [1, K, 1, D, N]
    h0 = h_bounds.reshape(Bsz, K, NC, N, D).transpose(-1, -2)  # [B, K, NC, D, N]
    abar = lambda t: torch.exp(dl_c[:, :, :, t, :, None] * Ak)
    hs, h = [], h0
    for t in range(T):
        h = abar(t) * h + (dl_c[:, :, :, t] * u_c[:, :, :, t])[..., None] \
            * B_c[:, :, :, t, None, :]
        hs.append(h)
    q = lambda t: C_c[:, :, :, t, None, :] * dy_c[:, :, :, t, :, None]
    z = torch.zeros_like(h0)
    for t in reversed(range(T)):
        z = abar(t) * (q(t) + z)
    decay = torch.exp(dl_c.sum(dim=3)[..., None] * Ak)
    cin, carry = torch.empty_like(z), torch.zeros_like(z[:, :, 0])
    for c in reversed(range(NC)):
        cin[:, :, c] = carry
        carry = decay[:, :, c] * carry + z[:, :, c]
    gu = torch.empty_like(u_c)
    gd = torch.empty_like(u_c)
    gB = torch.empty_like(B_c)
    gC = torch.empty_like(C_c)
    gA = torch.zeros_like(h0)
    z = cin
    for t in reversed(range(T)):
        ab = abar(t)
        gh = q(t) + z
        hp = hs[t - 1] if t > 0 else h0
        dlt, ut = dl_c[:, :, :, t], u_c[:, :, :, t]
        sB = (gh * B_c[:, :, :, t, None, :]).sum(-1)
        gha = gh * hp * ab
        gu[:, :, :, t] = Dskip.float()[None, :, None, :] * dy_c[:, :, :, t] + dlt * sB
        gdlp = ut * sB + (gha * Ak).sum(-1)
        gd[:, :, :, t] = gdlp * torch.sigmoid(raw_c[:, :, :, t])
        gB[:, :, :, t] = (gh * (dlt * ut)[..., None]).sum(-2)
        gC[:, :, :, t] = (hs[t] * dy_c[:, :, :, t, :, None]).sum(-2)
        gA = gA + gha * dlt[..., None]
        z = ab * gh
    unchunk = lambda x: x.reshape(Bsz, K, NC * T, x.shape[-1])[:, :, :L]
    gd = unchunk(gd)
    return (unchunk(gu).to(u.dtype), gd.to(delta.dtype), gA.sum(dim=(0, 2)).to(A.dtype),
            unchunk(gB).to(Bmat.dtype), unchunk(gC).to(Cmat.dtype),
            (dy.float() * u.float()).sum(dim=(0, 2)).to(Dskip.dtype),
            gd.sum(dim=(0, 2)).to(delta_bias.dtype))


# --- kernels -----------------------------------------------------------------


def _scan_forward_cuda(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk: int,
                       bounds_only: bool = False):
    Bsz, K, L, D = u.shape
    N = A.shape[-1]
    io = u.dtype
    u, delta, Bmat, Cmat = (t.to(io).contiguous() for t in (u, delta, Bmat, Cmat))
    f32 = lambda t: t.detach().float().contiguous()
    A32, Ds32, bias32 = f32(A), f32(Dskip), f32(delta_bias)
    dev = u.device
    _build.expect(dev, delta=(delta, (Bsz, K, L, D)), Bmat=(Bmat, (Bsz, K, L, N)),
                  Cmat=(Cmat, (Bsz, K, L, N)), A=(A32, (K, D, N)), Dskip=(Ds32, (K, D)),
                  delta_bias=(bias32, (K, D)))
    G, NC = Bsz * K, -(-L // chunk)
    y = None if bounds_only else torch.empty_like(u)
    hb = torch.empty(G, NC, N, D, device=dev)
    dsum = torch.empty(G * NC * D, device=dev)
    yacc = torch.empty(G * L * D, device=dev) if N > _GROUP and not bounds_only else None
    fn = _build.kernel("scan", "scan_forward", 11, [ctypes.c_int] * 7)
    rc = fn(*map(_build.ptr, (u, delta, Bmat, Cmat, A32, Ds32, bias32, y, hb, dsum, yacc)),
            G, K, L, D, N, chunk, _build.dtype_code(u), _build.stream())
    _build.check(rc, "scan_forward")
    scan_forward.launches += 1
    return y, hb


def _scan_backward_cuda(u, delta, A, Bmat, Cmat, Dskip, delta_bias, h_bounds, dy,
                        chunk: int):
    Bsz, K, L, D = u.shape
    N = A.shape[-1]
    io = u.dtype
    u, delta, Bmat, Cmat, dy = (t.to(io).contiguous() for t in (u, delta, Bmat, Cmat, dy))
    f32 = lambda t: t.detach().float().contiguous()
    A32, Ds32, bias32, hb = f32(A), f32(Dskip), f32(delta_bias), f32(h_bounds)
    # gB/gC partials, one per channel tile: room for the smallest tile (32)
    G, NC, nb = Bsz * K, -(-L // chunk), -(-D // 32)
    dev = u.device
    _build.expect(dev, delta=(delta, (Bsz, K, L, D)), Bmat=(Bmat, (Bsz, K, L, N)),
                  Cmat=(Cmat, (Bsz, K, L, N)), A=(A32, (K, D, N)), Dskip=(Ds32, (K, D)),
                  delta_bias=(bias32, (K, D)), h_bounds=(hb, (G, NC, N, D)),
                  dy=(dy, (Bsz, K, L, D)))
    gu, gdl = torch.empty_like(u), torch.empty_like(u)
    gB, gC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    gA = torch.empty(K, D, N, device=dev)
    gD, gbias = torch.empty(K, D, device=dev), torch.empty(K, D, device=dev)
    scratch = lambda n: torch.empty(n, device=dev)
    zl, dsum = scratch(G * NC * N * D), scratch(G * NC * D)
    gBp, gCp = scratch(G * L * N * nb), scratch(G * L * N * nb)
    gAp, gDp, gbp = scratch(G * NC * N * D), scratch(G * NC * D), scratch(G * NC * D)
    sacc, hacc = (scratch(G * L * D), scratch(G * L * D)) if N > _GROUP else (None, None)
    fn = _build.kernel("scan", "scan_backward", 25, [ctypes.c_int] * 8)
    rc = fn(*map(_build.ptr, (u, delta, Bmat, Cmat, A32, Ds32, bias32, hb, dy, gu, gdl, gB,
                              gC, gA, gD, gbias, zl, dsum, gBp, gCp, gAp, gDp, gbp, sacc, hacc)),
            Bsz, K, L, D, N, chunk, nb, _build.dtype_code(u), _build.stream())
    _build.check(rc, "scan_backward")
    scan_backward.launches += 1
    return (gu, gdl.to(delta.dtype), gA.to(A.dtype), gB, gC, gD.to(Dskip.dtype),
            gbias.to(delta_bias.dtype))


def scan_forward(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk: Optional[int] = None,
                 bounds_only: bool = False):
    """``(y [B,K,L,D] at u's dtype, h_bounds [B*K, NC, N, D] fp32)``; with
    ``bounds_only`` y is None and the kernel writes h_bounds alone (the same
    bits).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    chunk = chunk or scan_chunk(A.shape[-1])
    if u.is_cuda:
        return _scan_forward_cuda(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk, bounds_only)
    y, hb = scan_forward_plain(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk)
    return (None if bounds_only else y), hb


def scan_backward(u, delta, A, Bmat, Cmat, Dskip, delta_bias, h_bounds, dy,
                  chunk: Optional[int] = None):
    """The seven gradients ``(gu, gdelta, gA, gB, gC, gDskip, gdelta_bias)``
    of ``scan_forward`` at cotangent ``dy``.  CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    chunk = chunk or scan_chunk(A.shape[-1])
    fn = _scan_backward_cuda if u.is_cuda else scan_backward_plain
    return fn(u, delta, A, Bmat, Cmat, Dskip, delta_bias, h_bounds, dy, chunk)


scan_forward.launches = 0
scan_backward.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """``selective_scan_pallas``'s custom_vjp: forward ``scan_forward`` (which
    saves ``h_bounds``), backward ``scan_backward``."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk):
        y, hb = scan_forward(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk)
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, Dskip, delta_bias, hb)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, gy):
        return (*scan_backward(*ctx.saved_tensors, gy.contiguous(), ctx.chunk), None)


def selective_scan(u, delta, A, Bmat, Cmat, Dskip, delta_bias, chunk: Optional[int] = None):
    """Differentiable selective scan (``selective_scan_pallas`` with
    ``delta_softplus=True``, the only value its callers pass): u, delta
    [B,K,L,D]; A [K,D,N]; Bmat, Cmat [B,K,L,N]; Dskip, delta_bias [K,D].
    Returns y at u's dtype.  ``chunk`` overrides :func:`scan_chunk`."""
    return SelectiveScanFn.apply(u, delta, A, Bmat, Cmat, Dskip, delta_bias,
                                 chunk or scan_chunk(A.shape[-1]))


def _projected_scan_bwd(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, h_bounds, g):
    """The backward of a scan whose delta/B/C are products of its input xs
    [B, 4, L, D] (``_ssf_bwd``, scan_pallas.py:791-812): delta/B/C again at
    the io dtype, ``scan_backward``, then the chain through the products.
    Returns ``(gxs, gw_delta, gw_b, gw_c, gA, gDskip, gdelta_bias)``."""
    io = xs.dtype
    wd, wb, wc = (w.to(io) for w in (w_delta, w_b, w_c))
    delta, Bmat, Cmat = xs @ wd[None], xs @ wb[None], xs @ wc[None]
    if h_bounds is None:  # JAX computes y here and discards it
        _, h_bounds = scan_forward(xs, delta, A, Bmat, Cmat, Dskip, delta_bias,
                                   bounds_only=True)
    gu, gdl, ga, gb, gc, gd, gbias = scan_backward(
        xs, delta, A, Bmat, Cmat, Dskip, delta_bias, h_bounds, g.to(io).contiguous())
    gxs = (gu + gdl @ wd.transpose(1, 2)[None] + gb @ wb.transpose(1, 2)[None]
           + gc @ wc.transpose(1, 2)[None])
    gwd = torch.einsum("bkld,bkle->kde", xs, gdl).to(w_delta.dtype)
    gwb = torch.einsum("bkld,bkln->kdn", xs, gb).to(w_b.dtype)
    gwc = torch.einsum("bkld,bkln->kdn", xs, gc).to(w_c.dtype)
    return gxs, gwd, gwb, gwc, ga, gd, gbias


# --- fused-projection scan ------------------------------------------------------


def scan_fused_forward_plain(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, chunk: int):
    """Plain version of ``scan_fused_forward``: the three projections
    (io-dtype operands, fp32 sums, unrounded) and the chunked scan;
    ``(y [B,4,L,D] at xs's dtype, h_bounds)``."""
    io = xs.dtype
    w = lambda t: t[None].to(io).float()
    sf = xs.float()
    y, hb = selective_scan_chunked(xs, sf @ w(w_delta), A, sf @ w(w_b), sf @ w(w_c), Dskip,
                                   delta_bias, chunk=chunk, return_bounds=True)
    return y.to(io), hb


def _fused_chunk(chunk: int, N: int) -> int:
    """Steps per chunk of the fused-projection kernel's passes at N
    (padded) states: the largest multiple of the h_bounds chunk ``chunk`` at
    most the image kernel's chunk (:func:`_image_chunk`), and at least
    ``chunk``; pass 2 writes h_bounds at every ``chunk`` steps inside it."""
    return chunk * max(1, _image_chunk(N) // chunk)


def _fused_wproj(w_delta, w_b, w_c, io):
    """The folded projection [4, D, D + 2Np] (delta | B | C) at the io dtype,
    B and C padded to Np = :func:`kernel_states` (N) states."""
    N = w_b.shape[-1]
    pad = (0, kernel_states(N) - N)
    return torch.cat([w_delta, F.pad(w_b, pad), F.pad(w_c, pad)], dim=-1).to(io).contiguous()


def _scan_fused_launch(xs, wproj, A, Dskip, delta_bias, chunk: int, bounds: bool):
    """The kernel on xs [B, 4, L, D] with the folded ``wproj`` of
    :func:`_fused_wproj`: ``(y, h_bounds [B*4, NC, N, D] or None)``."""
    Bsz, K, L, D = xs.shape
    N0 = A.shape[-1]
    if K != 4:
        raise ValueError(f"scan_fused_forward takes the 4 SS2D directions, got K = {K}")
    xs = xs.contiguous()
    (A,) = pad_states(A)
    N = A.shape[-1]
    A32, Ds32, bias32 = _cache.f32(A), _cache.f32(Dskip), _cache.f32(delta_bias)
    dev = xs.device
    _build.expect(dev, wproj=(wproj, (4, D, D + 2 * N)), A=(A32, (4, D, N)),
                  Dskip=(Ds32, (4, D)), delta_bias=(bias32, (4, D)))
    G, TC = Bsz * 4, _fused_chunk(chunk, N)
    NC = -(-L // TC)
    y = torch.empty_like(xs)
    hb = torch.empty(G, -(-L // chunk), N, D, device=dev) if bounds else None
    # fp32 scratch in one allocation: proj, the passes' chunk states and
    # delta' sums, and, above 64 states, yacc
    sizes = (G * L * (D + 2 * N), G * NC * N * D, G * NC * D, G * L * D if N > _GROUP else 0)
    proj, hs, dsum, yacc = torch.empty(sum(sizes), device=dev).split(sizes)
    yacc = yacc if N > _GROUP else None
    fn = _build.kernel("scan", "scan_fused_forward", 11, [ctypes.c_int] * 7)
    rc = fn(*map(_build.ptr, (xs, wproj, A32, Ds32, bias32, y, hb, proj, dsum, yacc, hs)),
            G, L, D, N, chunk, TC, _build.dtype_code(xs), _build.stream())
    _build.check(rc, "scan_fused_forward")
    scan_fused_forward.launches += 1
    return y, (hb if hb is None or N == N0 else hb[:, :, :N0])


def _scan_fused_cuda(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, chunk: int,
                     bounds: bool = True):
    io = xs.dtype
    wproj = _cache.derived(("ssf_wproj", io), (w_delta, w_b, w_c),
                           lambda: _fused_wproj(w_delta.detach(), w_b.detach(), w_c.detach(), io))
    return _scan_fused_launch(xs, wproj, A, Dskip, delta_bias, chunk, bounds)


def scan_fused_forward(xs, w_delta, w_b, w_c, A, Dskip, delta_bias,
                       chunk: Optional[int] = None, bounds: bool = True):
    """The scan of xs [B, 4, L, D] with delta = xs @ w_delta [4, D, D], B =
    xs @ w_b, C = xs @ w_c ([4, D, N]): ``(y [B,4,L,D] at xs's dtype,
    h_bounds [B*4, NC, N, D] fp32)``, h_bounds as ``scan_forward`` gives
    them at the same ``chunk``; ``bounds=False`` returns None for them (the
    kernel then writes none).  CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    chunk = chunk or scan_chunk(A.shape[-1])
    if xs.is_cuda:
        return _scan_fused_cuda(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, chunk, bounds)
    y, hb = scan_fused_forward_plain(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, chunk)
    return y, (hb if bounds else None)


scan_fused_forward.launches = 0


class SelectiveScanFusedFn(torch.autograd.Function):
    """``_selective_scan_pallas_fused``'s custom_vjp: ``apply(xs, w_delta,
    w_b, w_c, A, Dskip, delta_bias)`` with the folded weights at xs's dtype.
    Forward ``scan_fused_forward`` (which saves ``h_bounds``); backward
    ``_ssf_bwd``'s: delta/B/C again at the io dtype, ``scan_backward`` and
    the chain through the projections."""

    @staticmethod
    def forward(ctx, xs, w_delta, w_b, w_c, A, Dskip, delta_bias):
        y, hb = scan_fused_forward(xs, w_delta, w_b, w_c, A, Dskip, delta_bias)
        ctx.save_for_backward(xs, w_delta, w_b, w_c, A, Dskip, delta_bias, hb)
        return y

    @staticmethod
    def backward(ctx, g):
        return _projected_scan_bwd(*ctx.saved_tensors, g)


def _derive_weights(x_proj_weight, dt_projs_weight, dt_rank: int, d_state: int):
    """Fold dt_projs into x_proj (ss2d_block.py:412-418,
    scan_pallas.py:839-844): w_delta [K, D, D], w_b / w_c [K, D, N]."""
    R, N = dt_rank, d_state
    wx = x_proj_weight
    w_delta = torch.einsum("krd,ker->kde", wx[:, :R, :], dt_projs_weight)
    w_b = wx[:, R:R + N, :].transpose(1, 2)
    w_c = wx[:, R + N:R + 2 * N, :].transpose(1, 2)
    return w_delta, w_b, w_c


def selective_scan_fused(xs, x_proj_weight, dt_projs_weight, A, Dskip, delta_bias,
                         dt_rank: int, d_state: int):
    """``selective_scan_pallas_fused`` (scan_pallas.py:817-850): the SS2D
    core of xs [B, 4, L, D] from the unfolded weights x_proj_weight [4,
    R+2N, D] and dt_projs_weight [4, D, R], with delta_softplus=True.  The
    dt low rank is folded into one [D, D] matrix and every weight cast to
    xs's dtype, as the JAX op does.  Returns y [B, 4, L, D] at xs's dtype;
    differentiable in every tensor argument.  A call on CUDA tensors that
    needs no gradient launches without the autograd Function, with the
    folded projection derived once per version of the two weights, and
    writes no h_bounds."""
    if xs.is_cuda and not _cache.needs_grad(xs, x_proj_weight, dt_projs_weight, A, Dskip,
                                            delta_bias):
        io = xs.dtype
        wproj = _cache.derived(
            ("ssf_wproj_unfolded", io, dt_rank, d_state), (x_proj_weight, dt_projs_weight),
            lambda: _fused_wproj(*_derive_weights(x_proj_weight.detach(),
                                                  dt_projs_weight.detach(), dt_rank,
                                                  d_state), io))
        return _scan_fused_launch(xs, wproj, A, Dskip, delta_bias, scan_chunk(A.shape[-1]),
                                  bounds=False)[0]
    w = _derive_weights(x_proj_weight, dt_projs_weight, dt_rank, d_state)
    return SelectiveScanFusedFn.apply(xs, *(t.to(xs.dtype) for t in w), A, Dskip, delta_bias)


def selective_scan_fused_plain(xs, x_proj_weight, dt_projs_weight, A, Dskip, delta_bias,
                               dt_rank: int, d_state: int):
    """The plain version of :func:`selective_scan_fused` on any device."""
    w = _derive_weights(x_proj_weight, dt_projs_weight, dt_rank, d_state)
    return scan_fused_forward_plain(xs, *(t.to(xs.dtype) for t in w), A, Dskip, delta_bias,
                                    scan_chunk(d_state))[0]


# --- image-direct scan --------------------------------------------------------

# The TPU kernel's VMEM budget (scan_pallas.py:42) and chunk rules, copied so
# that image_scan_vmem_ok routes exactly as the JAX package does.
_VMEM_BUDGET = 16 * 1024 * 1024


def _pick_chunk(G: int, D: int, N: int, L: int) -> int:
    per_step_bytes = (4 * N + 12) * D * 4 + 4 * N * 4
    s = max(16, min(1024, _VMEM_BUDGET // max(per_step_bytes, 1)))
    p = 1
    while p * 2 <= s:
        p *= 2
    while p // 2 >= L and p > 16:
        p //= 2
    return p


def _pick_image_s(major: int, minor: int, D: int, N: int, B: int, col_major: bool) -> int:
    target = _pick_chunk(2 * B, D, N, major * minor)
    s = max(1, min(major, target // max(minor, 1)))
    while major % s:
        s -= 1
    if col_major and s % 8 and s != major:
        s = major if major < 8 else 8
        while s > 1 and major % s:
            s //= 2
        if s % 8 and s != major:
            return 0
    return s


def image_scan_vmem_ok(H: int, W: int, d_inner: int, d_state: int) -> bool:
    """The JAX routing of the SS2D remat scan (scan_pallas.py:1101-1115):
    the image-direct scan where this holds, the decimated scan elsewhere.

    The predicate is the TPU kernel's VMEM budget, not a limit of the H100
    kernel, which takes every even grid; it is kept so that the port runs
    the same kernels at the same blocks as the JAX package (at 512^2 the
    five shallow blocks take the image scan, the four deep ones the
    decimated scan).  A later change may replace it after a measurement on
    the H100."""
    H2, W2 = H // 2, W // 2
    s_row = _pick_image_s(H2, W2, d_inner, d_state, 1, col_major=False)
    s_col = _pick_image_s(W2, H2, d_inner, d_state, 1, col_major=True)
    if not (s_row and s_col):
        return False
    S = s_col * H2
    return 4 * d_state * S * d_inner * 4 <= 40 * 1024 * 1024


def _image_chunk(N: int) -> int:
    """Steps per chunk of the image kernel (csrc/scan_image.cu) at N states
    (padded): chunk * min(N, 64) held at 1024, 32 to 256 steps, so that a
    chunk's B and C rows take at most 16 KB of shared memory."""
    return max(32, min(256, 1024 // min(N, _GROUP)))


def scan_image_forward_plain(x, w_delta, w_b, w_c, A, Dskip, delta_bias):
    """Plain version of ``scan_image_forward``: EfficientScan, then the plain
    fused-projection scan at the image kernel's chunk; ys [B, 4, L, D] at
    x's dtype."""
    return scan_fused_forward_plain(efficient_scan(x, 2), w_delta, w_b, w_c, A, Dskip,
                                    delta_bias, _IMAGE_CHUNK)[0]


def _scan_image_cuda(x, w_delta, w_b, w_c, A, Dskip, delta_bias):
    B, H, W, D = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"scan_image_forward needs even H, W, got {H}x{W}")
    io = x.dtype
    x = x.contiguous()
    A, w_b, w_c = pad_states(A, w_b, w_c)
    N = A.shape[-1]
    wproj = torch.cat([w_delta, w_b, w_c], dim=-1).to(io).contiguous()  # [4, D, D+2N]
    f32 = lambda t: t.detach().float().contiguous()
    A32, Ds32, bias32 = f32(A), f32(Dskip), f32(delta_bias)
    dev = x.device
    _build.expect(dev, wproj=(wproj, (4, D, D + 2 * N)), A=(A32, (4, D, N)),
                  Dskip=(Ds32, (4, D)), delta_bias=(bias32, (4, D)))
    L = (H // 2) * (W // 2)
    G, TC = B * 4, _image_chunk(N)
    NC = -(-L // TC)
    ys = torch.empty(B, 4, L, D, device=dev, dtype=io)
    # fp32 scratch in one allocation: proj, hb, dsum and, above 64 states, yacc
    sizes = (G * L * (D + 2 * N), G * NC * N * D, G * NC * D, G * L * D if N > _GROUP else 0)
    proj, hb, dsum, yacc = torch.empty(sum(sizes), device=dev).split(sizes)
    yacc = yacc if N > _GROUP else None
    fn = _build.kernel("scan_image", "scan_image_forward", 10, [ctypes.c_int] * 7)
    rc = fn(*map(_build.ptr, (x, wproj, A32, Ds32, bias32, ys, proj, hb, dsum, yacc)),
            B, H, W, D, N, TC, _build.dtype_code(x), _build.stream())
    _build.check(rc, "scan_image_forward")
    scan_image_forward.launches += 1
    return ys


def scan_image_forward(x, w_delta, w_b, w_c, A, Dskip, delta_bias):
    """The four decimated direction scans of x [B, H, W, D] (even H, W) with
    w_delta [4, D, D], w_b, w_c [4, D, N]: ys [B, 4, L, D] at x's dtype in
    ``efficient_scan`` order.  CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    fn = _scan_image_cuda if x.is_cuda else scan_image_forward_plain
    return fn(x, w_delta, w_b, w_c, A, Dskip, delta_bias)


scan_image_forward.launches = 0


class ScanImageFn(torch.autograd.Function):
    """``_scan_image``'s custom_vjp, the differentiable SS2D core straight
    from the NHWC image: ``apply(x, w_delta, w_b, w_c, A, Dskip,
    delta_bias)`` with the folded projections at x's dtype (as
    ``ss2d_block._derive_weights`` gives them) returns ys [B, 4, L, D] in
    ``efficient_scan`` order (the JAX ``selective_scan_image`` returns the
    same four directions as row and column pairs).  Forward
    ``scan_image_forward``; backward as ``_scan_image_bwd``
    (scan_pallas.py:1063-1095): EfficientScan, the three projections at the
    io dtype, ``scan_forward`` for ``h_bounds``, ``scan_backward``, the
    projection gradients and EfficientMerge."""

    @staticmethod
    def forward(ctx, x, w_delta, w_b, w_c, A, Dskip, delta_bias):
        ctx.save_for_backward(x, w_delta, w_b, w_c, A, Dskip, delta_bias)
        return scan_image_forward(x, w_delta, w_b, w_c, A, Dskip, delta_bias)

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        B, H, W, D = x.shape
        gxs, *grads = _projected_scan_bwd(efficient_scan(x, 2), *rest, None, g)
        return (efficient_merge(gxs, H, W, 2).to(x.dtype), *grads)


def scan_image(x, w_delta, w_b, w_c, A, Dskip, delta_bias):
    """The differentiable image-direct scan, :class:`ScanImageFn`; its plain
    version is :func:`scan_image_forward_plain` under autograd."""
    return ScanImageFn.apply(x, w_delta, w_b, w_c, A, Dskip, delta_bias)


__all__ = ["SelectiveScanFn", "SelectiveScanFusedFn", "ScanImageFn", "image_scan_vmem_ok",
           "kernel_states", "pad_states", "scan_backward", "scan_backward_plain",
           "scan_chunk", "scan_forward", "scan_forward_plain", "scan_fused_forward",
           "scan_fused_forward_plain",
           "scan_image", "scan_image_forward", "scan_image_forward_plain", "selective_scan",
           "selective_scan_fused", "selective_scan_fused_plain"]
