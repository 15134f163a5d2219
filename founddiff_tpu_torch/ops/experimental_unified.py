"""Unified MambaBlock first half: LN + modulate, in_proj, the depthwise 3x3,
silu, the four-direction scan and the whole SS2D tail, from the raw input.

Counterpart of ``founddiff_tpu/ops/experimental_unified.py`` (default off
there and here).  The route is read at call time from ``FOUNDDIFF_UNIFIED``
exactly as the JAX package reads it (models/ss2d.py:228-229): the value
``"1"`` turns it on.  ``ss2d_mamba_block`` replaces the TPU kernels
``_mblock_row_kernel`` (experimental_unified.py:173) and
``_mblock_col_kernel`` (:265), both launched by ``_mblock_call`` (:533):

    out = x + gate * out_proj( LN(scan(silu(dwconv(x1 @ Wx)))) * silu(x1 @ Wz)
                               + local ),
    x1  = modulate(LayerNorm(x; ln_scale, ln_bias); mod_scale, mod_shift)

CUDA tensors go to ``csrc/mamba_block.cu``; CPU tensors to the plain version
:func:`_mamba_block_plain`, which follows the TPU kernel's own arithmetic:
LN-centred rows without affine rounded to the io dtype, the affine folded
into the in_proj weights (``round_io(W * geff)``, with ``beff @ W`` in fp32
as a bias), the taps at the io dtype summed in fp32, then the scan and tail
of :func:`~founddiff_tpu_torch.ops.ss2d_block._ss2d_tail_plain`.  In fp32
that equals :func:`mamba_compose` to rounding; in bf16 it rounds elsewhere.

The backward is ``_mb_bwd``'s (:661-668): autograd through
:func:`mamba_compose`, the port of ``_mamba_xla_compose`` (:560-587), whose
SS2D part is :func:`~founddiff_tpu_torch.ops.ss2d_block.ss2d_compose` with
the scan kernels of :mod:`founddiff_tpu_torch.ops.scan`.

Weights in the port's layouts: in_proj_w [2D, C0] (``in_proj.weight``),
dw_kernel [D, 1, 3, 3] (``conv2d.weight``), proj_w [C0, D]
(``out_proj.weight``).
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.ops.remat import remat_grads
from founddiff_tpu_torch.ops.ss2d_block import (
    _CHUNK,
    _STATE_SIZES,
    _derive_weights,
    _ss2d_tail_plain,
    block_scan_ok,
    ss2d_compose,
)


def unified_route() -> bool:
    """The unified route: ``FOUNDDIFF_UNIFIED`` is ``"1"``."""
    return os.environ.get("FOUNDDIFF_UNIFIED", "0") == "1"


def mamba_block_ok(H: int, W: int) -> bool:
    """Shapes the unified op takes: those of the fused SS2D block, even H and
    W of at least 4.  The JAX gate adds VMEM terms, a Mosaic limit the H100
    kernel does not have; at the nine MambaBlocks of ``Config()`` at 512^2
    both gates hold."""
    return block_scan_ok(H, W)


def _ln_center(x, eps_ln):
    """LayerNorm rows without affine, rounded to x's dtype: fp32 sums of the
    io values and their squares, ``var = E[x^2] - mean^2`` (``_ln_center``,
    experimental_unified.py:38-62)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    return ((xf - mean) * torch.rsqrt(var + eps_ln)).to(x.dtype)


def fold_affine(w, geff, beff, io):
    """Per-image in_proj weights with the LN affine and adaLN modulation
    folded in (experimental_unified.py:196-209): w [C0, D] rounded to io and
    widened; returns ``round_io(w * geff_b)`` [B, C0, D] and ``beff_b @ w``
    [B, D] fp32."""
    wf = w.to(io).float()
    return (wf[None] * geff.float()[:, :, None]).to(io), beff.float() @ wf


def _dwconv_taps(u, dwt, dwb):
    """The depthwise 3x3 of u [B, H, W, D] with SAME padding: taps dwt [9, D]
    at u's dtype, fp32 sums, the fp32 bias dwb [D]."""
    D = u.shape[-1]
    k = dwt.to(u.dtype).float().t().reshape(D, 1, 3, 3)
    y = F.conv2d(u.float().permute(0, 3, 1, 2), k, padding=1, groups=D)
    return y.permute(0, 2, 3, 1) + dwb.float()


def _mamba_block_plain(x, geff, beff, wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip,
                       delta_bias, ln_g, ln_b, local, proj_w, gate, eps_ln, eps):
    B, H, W, C0 = x.shape
    io = x.dtype
    xc = _ln_center(x, eps_ln).float().reshape(B, H * W, C0)
    wxg, bx = fold_affine(wx, geff, beff, io)
    wzg, bz = fold_affine(wz, geff, beff, io)
    u = (xc @ wxg.float() + bx[:, None]).to(io).reshape(B, H, W, -1)
    acc = _dwconv_taps(u, dwt, dwb)
    xs = (acc * torch.sigmoid(acc)).to(io)
    z = (xc @ wzg.float() + bz[:, None]).to(io).float().reshape(B, H, W, -1)
    return _ss2d_tail_plain(z, xs, x, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b,
                            local, proj_w, gate, eps)


def _mamba_block_cuda(x, geff, beff, wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip,
                      delta_bias, ln_g, ln_b, local, proj_w, gate, eps_ln, eps):
    B, H, W, C0 = x.shape
    D, N = wx.shape[-1], A.shape[-1]
    io = x.dtype
    if N not in _STATE_SIZES:
        raise ValueError(f"d_state {N} not in {_STATE_SIZES}")
    if not mamba_block_ok(H, W):
        raise ValueError(f"ss2d_mamba_block needs even H, W >= 4, got {H}x{W}")
    _build.dtype_code(x)
    x = x.contiguous()
    f32 = lambda t: t.detach().float().contiguous()
    wxg, bx = (t.detach().contiguous() for t in fold_affine(wx, geff, beff, io))
    wzg, bz = (t.detach().contiguous() for t in fold_affine(wz, geff, beff, io))
    taps = dwt.detach().to(io).contiguous()
    wproj = torch.cat([w_delta, w_b, w_c], dim=-1).detach().to(io).contiguous()
    pw = proj_w.detach().to(io).contiguous()
    dwb32, A32, Ds32, bias32 = f32(dwb), f32(A), f32(Dskip), f32(delta_bias)
    g32, b32 = f32(ln_g), f32(ln_b)
    loc32 = None if local is None else f32(local)
    gate32 = gate.detach().to(io).float().contiguous()
    dev = x.device
    _build.expect(dev, wxg=(wxg, (B, C0, D)), bx=(bx, (B, D)), wzg=(wzg, (B, C0, D)),
                  bz=(bz, (B, D)), taps=(taps, (9, D)), dw_bias=(dwb32, (D,)),
                  wproj=(wproj, (4, D, D + 2 * N)), A=(A32, (4, D, N)),
                  Dskip=(Ds32, (4, D)), delta_bias=(bias32, (4, D)), ln_g=(g32, (D,)),
                  ln_b=(b32, (D,)), local=(loc32, (B, D)), proj_w=(pw, (D, C0)),
                  gate=(gate32, (B, C0)))
    L = (H // 2) * (W // 2)
    NC = -(-L // _CHUNK)
    act = lambda c: torch.empty(B, H, W, c, device=dev, dtype=io)
    xc, u, xs, og = act(C0), act(D), act(D), act(D)
    proj_buf = torch.empty(B * 4 * L * (D + 2 * N), device=dev)
    chunk_sum = torch.empty(B * 4 * NC * D, device=dev)
    chunk_state = torch.empty(B * 4 * NC * D * N, device=dev)
    ybuf = torch.empty(B * H * W * D, device=dev)
    stats = torch.empty(B * H * W * 2, device=dev)
    out = torch.empty_like(x)
    fn = _build.declare(_build.load("mamba_block"), "mamba_block_forward", 26,
                        [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (x, wxg, bx, wzg, bz, taps, dwb32, wproj, A32, Ds32, bias32, g32,
                              b32, loc32, pw, gate32, out, xc, u, xs, proj_buf, chunk_sum,
                              chunk_state, ybuf, stats, og)),
            B, H, W, C0, D, N, _CHUNK, eps_ln, eps, _build.dtype_code(x), _build.stream())
    _build.check(rc, "mamba_block_forward")
    ss2d_mamba_block.launches += 1
    return out


def mamba_compose(x, geff, beff, wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip, delta_bias,
                  ln_g, ln_b, local, proj_w, gate, eps_ln, eps):
    """The remat composition (``_mamba_xla_compose``), differentiable: LN +
    modulate rounded to the io dtype, ``x1 @ Wx``, the depthwise 3x3 at the
    io dtype and its bias, silu, then :func:`ss2d_compose`."""
    D = wx.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    x1 = (xf - mean) * torch.rsqrt(var + eps_ln)
    x1 = (x1 * geff.float()[:, None, None, :] + beff.float()[:, None, None, :]).to(x.dtype)
    xs = x1 @ wx.to(x1.dtype)
    k = dwt.t().reshape(D, 1, 3, 3).to(xs.dtype)
    xs = F.conv2d(xs.permute(0, 3, 1, 2), k, padding=1, groups=D).permute(0, 2, 3, 1)
    xs = xs + dwb.to(xs.dtype)
    xs = F.silu(xs.float()).to(xs.dtype)
    return ss2d_compose(x1, xs, x, wz, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b,
                        local, proj_w, gate, eps)


class _MambaBlockFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: autograd through :func:`mamba_compose`."""

    @staticmethod
    def forward(ctx, eps_ln, eps, *args):
        ctx.eps_ln, ctx.eps = eps_ln, eps
        ctx.save_for_backward(*args)
        fn = _mamba_block_cuda if args[0].is_cuda else _mamba_block_plain
        return fn(*args, eps_ln, eps)

    @staticmethod
    def backward(ctx, g):
        eps_ln, eps = ctx.eps_ln, ctx.eps
        return (None, None, *remat_grads(lambda *a: mamba_compose(*a, eps_ln, eps),
                                         ctx.saved_tensors, ctx.needs_input_grad[2:], g))


def _split_args(x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
                x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b,
                local, proj_w, gate, d_inner, dt_rank, d_state):
    """The op's operands as ``ss2d_mamba_block`` (:694-717) forms them: geff
    and beff in fp32, the in_proj halves and the folded scan projections at
    the io dtype, the taps [9, D]."""
    B, C0 = x.shape[0], x.shape[-1]
    io = x.dtype
    w_delta, w_b, w_c = _derive_weights(x_proj_weight, dt_projs_weight, dt_rank, d_state)
    ms = mod_scale.float().reshape(B, C0)
    mt = mod_shift.float().reshape(B, C0)
    geff = ln_scale.float()[None] * (1.0 + ms)
    beff = ln_bias.float()[None] * (1.0 + ms) + mt
    dwt = dw_kernel[:, 0].reshape(d_inner, 9).t()
    if dw_bias is None:  # as the JAX op: zeros, and adding them is exact
        dw_bias = x.new_zeros(d_inner, dtype=torch.float32)
    return (x, geff, beff, in_proj_w[:d_inner].t().to(io), in_proj_w[d_inner:].t().to(io), dwt,
            dw_bias, w_delta.to(io), w_b.to(io), w_c.to(io), A, Dskip, delta_bias, out_ln_g,
            out_ln_b, local, proj_w.t(), gate)


def ss2d_mamba_block(x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
                     x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b,
                     local, proj_w, gate, d_inner: int, dt_rank: int, d_state: int,
                     eps_ln: float = 1e-5, eps: float = 1e-5):
    """The whole first half of a MambaBlock from its raw input x [B,H,W,C0]:
    norm1's ln_scale, ln_bias [C0]; the adaLN mod_scale, mod_shift, gate
    [B, C0]; in_proj_w [2D, C0]; dw_kernel [D, 1, 3, 3], dw_bias [D] or None;
    x_proj_weight [4, R+2N, D]; dt_projs_weight [4, D, R]; A [4, D, N]
    (negative); Dskip, delta_bias [4, D]; out_ln_g, out_ln_b [D]; local
    [B, D] or None; proj_w [C0, D].  Requires :func:`mamba_block_ok`.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Differentiable in every tensor argument."""
    return _MambaBlockFn.apply(eps_ln, eps, *_split_args(
        x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
        x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b, local, proj_w,
        gate, d_inner, dt_rank, d_state))


def ss2d_mamba_block_plain(x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel,
                           dw_bias, x_proj_weight, dt_projs_weight, A, Dskip, delta_bias,
                           out_ln_g, out_ln_b, local, proj_w, gate, d_inner: int, dt_rank: int,
                           d_state: int, eps_ln: float = 1e-5, eps: float = 1e-5):
    """The plain version of :func:`ss2d_mamba_block` on any device: the
    oracle the kernel is held against."""
    return _mamba_block_plain(*_split_args(
        x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
        x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b, local, proj_w,
        gate, d_inner, dt_rank, d_state), eps_ln, eps)


ss2d_mamba_block.launches = 0

__all__ = ["mamba_block_ok", "mamba_compose", "ss2d_mamba_block", "ss2d_mamba_block_plain",
           "unified_route"]
