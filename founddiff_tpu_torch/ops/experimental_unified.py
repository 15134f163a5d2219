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

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.remat import remat_op
from founddiff_tpu_torch.ops.scan import _GROUP, scan_weights
from founddiff_tpu_torch.ops.ss2d_block import (
    _CHUNK,
    _ss2d_tail_plain,
    block_scan_ok,
    ss2d_compose,
)
from founddiff_tpu_torch.utils import trace


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


def _dw_bias(dwb, like):
    """The depthwise bias dwb [D], or for None fp32 zeros on ``like``'s
    device (as the JAX op: adding them is exact)."""
    return like.new_zeros(like.shape[-1], dtype=torch.float32) if dwb is None else dwb


def _dwconv_taps(u, dwt, dwb):
    """The depthwise 3x3 of u [B, H, W, D] with SAME padding: taps dwt [9, D]
    at u's dtype, fp32 sums, the fp32 bias dwb [D] or None."""
    D = u.shape[-1]
    k = dwt.to(u.dtype).float().t().reshape(D, 1, 3, 3)
    y = F.conv2d(u.float().permute(0, 3, 1, 2), k, padding=1, groups=D)
    return y.permute(0, 2, 3, 1) + _dw_bias(dwb, dwt).float()


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


def _kernel_weights(wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b,
                    proj_w, io):
    """The kernel's weight operands, which depend on parameters only: in_proj's
    halves at the io dtype and widened, stacked [2, C0, D] (the fold's
    operand), the taps and out_proj at the io dtype, the scan's
    (:func:`~founddiff_tpu_torch.ops.scan.scan_weights`), the rest in fp32."""
    wproj, A, Ds, bias = scan_weights(io, w_delta, w_b, w_c, A=A, Dskip=Dskip,
                                      delta_bias=delta_bias)
    w = dict(wf=torch.stack([wx.detach().to(io).float(), wz.detach().to(io).float()]),
             taps=dwt.detach().to(io).contiguous(), dwb=_cache.f32(_dw_bias(dwb, dwt)),
             wproj=wproj, pw=proj_w.detach().to(io).contiguous(), A=A, Ds=Ds, bias=bias,
             g=_cache.f32(ln_g), b=_cache.f32(ln_b))
    C0, D = w["wf"].shape[1:]
    N = w["A"].shape[-1]
    if C0 % 8 or D % 8:  # the front kernel's 16-byte vectors
        raise ValueError(f"ss2d_mamba_block's kernel takes C0 and D multiples of 8, got "
                         f"{C0} and {D}")
    _build.expect(w["wf"].device, wf=(w["wf"], (2, C0, D)), taps=(w["taps"], (9, D)),
                  dw_bias=(w["dwb"], (D,)), wproj=(w["wproj"], (4, D, D + 2 * N)),
                  A=(w["A"], (4, D, N)), Dskip=(w["Ds"], (4, D)),
                  delta_bias=(w["bias"], (4, D)), ln_g=(w["g"], (D,)), ln_b=(w["b"], (D,)),
                  proj_w=(w["pw"], (D, C0)))
    return w


@trace.traced("kernel.mamba_block_forward")
def _launch(x, geff, beff, w, local, gate, eps_ln, eps):
    """One ``mamba_block_forward`` launch: the LN affine and the modulation
    folded into in_proj per image (``fold_affine``'s arithmetic, both halves
    at once), the scratch carved from one allocation."""
    B, H, W, C0 = x.shape
    D, N = w["wf"].shape[-1], w["A"].shape[-1]
    io = x.dtype
    if not mamba_block_ok(H, W):
        raise ValueError(f"ss2d_mamba_block needs even H, W >= 4, got {H}x{W}")
    code = _build.dtype_code(x)
    x = x.contiguous()
    if w["wf"].shape[1] != C0 or w["wf"].device != x.device:
        raise ValueError(f"in_proj [{w['wf'].shape[1]}, {D}] on {w['wf'].device} does not "
                         f"take x [..., {C0}] on {x.device}")
    # round_io(W * geff_b) for both halves in one launch: the fp32 product
    # rounded as it is stored; bx_b and bz_b = beff_b W
    wg = torch.empty((2, B, C0, D), dtype=io, device=x.device)
    torch.mul(w["wf"][:, None], geff[None, :, :, None], out=wg)
    bxz = beff @ w["wf"]  # [2, B, D]
    loc32 = None if local is None else local.detach().float().contiguous()
    gate32 = gate.detach().to(io).float().contiguous()
    _build.expect(x.device, local=(loc32, (B, D)), gate=(gate32, (B, C0)))
    P, L = B * H * W, (H // 2) * (W // 2)
    NC = -(-L // _CHUNK)
    isz = x.element_size()
    # bytes of the scratch: xc, xs, og at the io dtype; the tail's fp32 buffers
    sizes = [P * C0 * isz, P * D * isz, P * D * isz, B * 4 * L * (D + 2 * N) * 4,
             B * 4 * NC * D * 4, B * 4 * NC * D * N * 4, P * D * 4,
             B * 4 * L * D * 4 if N > _GROUP else 0, P * 2 * 4]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    xc, xs, og, proj, csum, cstate, ybuf, yacc, stats = (
        base + o if n else None for o, n in zip(offsets, sizes))
    out = torch.empty_like(x)
    fn = _build.kernel("mamba_block", "mamba_block_forward", 26,
                       [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (x, wg[0], bxz[0], wg[1], bxz[1], w["taps"], w["dwb"], w["wproj"],
                              w["A"], w["Ds"], w["bias"], w["g"], w["b"], loc32, w["pw"],
                              gate32, out)),
            xc, xs, proj, csum, cstate, ybuf, yacc, stats, og,
            B, H, W, C0, D, N, _CHUNK, eps_ln, eps, code, _build.stream())
    _build.check(rc, "mamba_block_forward")
    return out


def _mamba_block_cuda(x, geff, beff, wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip,
                      delta_bias, ln_g, ln_b, local, proj_w, gate, eps_ln, eps):
    """The kernel with its weight operands derived once per version of their
    sources (formed on each call under a recorded call, whose folded weights
    carry autograd history)."""
    io = x.dtype
    sources = (w_delta, w_b, w_c, wx, wz, dwt, A, Dskip, delta_bias, ln_g, ln_b, proj_w)
    w = _cache.derived(("mamba_block", io, dwb is None),
                       sources if dwb is None else (*sources, dwb),
                       lambda: _kernel_weights(wx, wz, dwt, dwb, w_delta, w_b, w_c, A, Dskip,
                                               delta_bias, ln_g, ln_b, proj_w, io))
    return _launch(x, geff, beff, w, local, gate, eps_ln, eps)


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
    xs = xs + _dw_bias(dwb, dwt).to(xs.dtype)
    xs = F.silu(xs.float()).to(xs.dtype)
    return ss2d_compose(x1, xs, x, wz, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b,
                        local, proj_w, gate, eps)


_MAMBA_BLOCK = remat_op("_MambaBlockFn", _mamba_block_cuda, _mamba_block_plain, mamba_compose,
                        tensors=18)


def _modulation(ln_scale, ln_bias, mod_scale, mod_shift):
    """geff and beff [B, C0] in fp32 (experimental_unified.py:694-717)."""
    B, C0 = mod_scale.shape[0], ln_scale.shape[-1]
    ms1 = 1.0 + mod_scale.float().reshape(B, C0)
    return (ln_scale.float()[None] * ms1,
            ln_bias.float()[None] * ms1 + mod_shift.float().reshape(B, C0))


def _split_args(x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
                x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b,
                local, proj_w, gate, d_inner, dt_rank, d_state):
    """The op's operands as ``ss2d_mamba_block`` (:694-717) forms them: geff
    and beff in fp32, the in_proj halves [C0, D], the taps [9, D], the
    folded scan projections at the io dtype (:func:`scan_weights`)."""
    geff, beff = _modulation(ln_scale, ln_bias, mod_scale, mod_shift)
    w_delta, w_b, w_c = scan_weights(x.dtype, x_proj_weight, dt_projs_weight, dt_rank=dt_rank,
                                     d_state=d_state)
    return (x, geff, beff, in_proj_w[:d_inner].t(), in_proj_w[d_inner:].t(),
            dw_kernel[:, 0].reshape(d_inner, 9).t(), dw_bias, w_delta, w_b, w_c, A, Dskip,
            delta_bias, out_ln_g, out_ln_b, local, proj_w.t(), gate)


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
    Differentiable in every tensor argument.  When no input needs a
    gradient, the call skips autograd and the weight operands are derived
    once per parameter version (:func:`._cache.derived`); the fold of the
    modulation runs at every call."""
    return _MAMBA_BLOCK(*_split_args(
        x, ln_scale, ln_bias, mod_scale, mod_shift, in_proj_w, dw_kernel, dw_bias,
        x_proj_weight, dt_projs_weight, A, Dskip, delta_bias, out_ln_g, out_ln_b, local, proj_w,
        gate, d_inner, dt_rank, d_state), eps_ln, eps)


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


__all__ = ["mamba_block_ok", "mamba_compose", "ss2d_mamba_block", "ss2d_mamba_block_plain",
           "unified_route"]
