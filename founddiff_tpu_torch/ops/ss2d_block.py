"""Fused SS2D block: the scan and the whole MambaBlock SS2D tail.

Replaces the TPU kernel ``_scan_block_kernel``
(``founddiff_tpu/ops/ss2d_block.py:50``, launched twice per SS2D by
``ss2d_image_block`` :542):

    out = x_raw + gate * out_proj( LN(scan(xs)) * silu(x1 @ W_z) + local )

on the four step-2 decimated directions, with the delta/B/C projections and
the softplus inside.  CUDA tensors go to ``csrc/ss2d_block.cu``; CPU tensors
to the plain version :func:`_ss2d_block_plain`.

The backward is ``_sib_bwd``'s (``ss2d_block.py:530-536``): autograd through
:func:`ss2d_compose`, the port of the remat composition ``_xla_compose``
(:474-515), whose scan runs the kernels of :mod:`founddiff_tpu_torch.ops.scan`.

Rounding follows the TPU kernel: projections take io-dtype operands with
fp32 sums; the scan state, the LayerNorm and the silu run in fp32; z and
the gated epilogue are rounded to the io dtype before their products; the
scan output y is never rounded.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.ops.remat import remat_grads
from founddiff_tpu_torch.ops.scan import ScanImageFn, image_scan_vmem_ok, selective_scan
from founddiff_tpu_torch.ops.selective_scan import (
    efficient_merge,
    efficient_scan,
    selective_scan_chunked,
)

_STATE_SIZES = (4, 8, 16, 32)
_CHUNK = 128  # scan chunk of the CUDA kernel (positions per chunk)


def block_scan_ok(H: int, W: int) -> bool:
    """Shapes the fused block takes: step-2 decimation needs even H and W."""
    return H % 2 == 0 and W % 2 == 0 and H >= 4 and W >= 4


def _derive_weights(x_proj_weight, dt_projs_weight, dt_rank: int, d_state: int):
    """Fold dt_projs into x_proj (ss2d_block.py:412-418):
    w_delta [K, D, D], w_b / w_c [K, D, N]."""
    R, N = dt_rank, d_state
    wx = x_proj_weight
    w_delta = torch.einsum("krd,ker->kde", wx[:, :R, :], dt_projs_weight)
    w_b = wx[:, R:R + N, :].transpose(1, 2)
    w_c = wx[:, R + N:R + 2 * N, :].transpose(1, 2)
    return w_delta, w_b, w_c


def _mm(a, w, io):
    """io-dtype operands, fp32 sums and fp32 result."""
    return a.to(io).float() @ w.to(io).float()


def _ss2d_block_plain(x1, xs, x_raw, w_z, w_delta, w_b, w_c, A, Dskip, delta_bias,
                      ln_g, ln_b, local, proj_w, gate, eps):
    z = _mm(x1, w_z, xs.dtype).to(xs.dtype).float()
    return _ss2d_tail_plain(z, xs, x_raw, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b,
                            local, proj_w, gate, eps)


def _ss2d_tail_plain(z, xs, x_raw, w_delta, w_b, w_c, A, Dskip, delta_bias, ln_g, ln_b, local,
                     proj_w, gate, eps):
    """The block after its z projection (z: fp32 of the io-rounded z), as
    ``csrc/ss2d_tail.cuh`` computes it: the scan, LN, the silu(z) gate,
    +local, out_proj and the gated residual."""
    B, H, W, D = xs.shape
    io = xs.dtype
    seq = efficient_scan(xs, 2)  # [B, 4, L, D]
    wk = lambda w: w[None].to(io).float()  # [1, K, D, *]
    dl = seq.float() @ wk(w_delta)
    bs = seq.float() @ wk(w_b)
    cs = seq.float() @ wk(w_c)
    ys = selective_scan_chunked(seq, dl, A, bs, cs, Dskip, delta_bias)
    y = efficient_merge(ys, H, W, 2)  # fp32
    mean = y.mean(dim=-1, keepdim=True)
    var = (y * y).mean(dim=-1, keepdim=True) - mean * mean
    yn = (y - mean) * torch.rsqrt(var + eps) * ln_g.float() + ln_b.float()
    og = yn * (z * torch.sigmoid(z))
    if local is not None:
        og = og + local.float()[:, None, None, :]
    fp = _mm(og.to(io), proj_w, io)
    gate_f = gate.to(io).float()[:, None, None, :]
    return (x_raw.float() + gate_f * fp).to(x_raw.dtype)


def _ss2d_block_cuda(x1, xs, x_raw, w_z, w_delta, w_b, w_c, A, Dskip, delta_bias,
                     ln_g, ln_b, local, proj_w, gate, eps):
    B, H, W, D = xs.shape
    C0 = x_raw.shape[-1]
    N = A.shape[-1]
    io = xs.dtype
    if x1.dtype != io or x_raw.dtype != io:
        raise TypeError("x1, xs and x_raw must share one dtype")
    if N not in _STATE_SIZES:
        raise ValueError(f"d_state {N} not in {_STATE_SIZES}")
    if not block_scan_ok(H, W):
        raise ValueError(f"ss2d_image_block needs even H, W >= 4, got {H}x{W}")
    x1, xs, x_raw = x1.contiguous(), xs.contiguous(), x_raw.contiguous()
    f32 = lambda t: t.detach().float().contiguous()
    wproj = torch.cat([w_delta, w_b, w_c], dim=-1).to(io).contiguous()  # [4, D, D+2N]
    wz = w_z.to(io).contiguous()
    pw = proj_w.to(io).contiguous()
    A32, Ds32, bias32 = f32(A), f32(Dskip), f32(delta_bias)
    g32, b32 = f32(ln_g), f32(ln_b)
    loc32 = None if local is None else f32(local)
    gate32 = gate.to(io).float().contiguous()
    dev = xs.device
    _build.expect(dev, x1=(x1, (B, H, W, C0)), x_raw=(x_raw, (B, H, W, C0)),
                  wproj=(wproj, (4, D, D + 2 * N)), w_z=(wz, (C0, D)), proj_w=(pw, (D, C0)),
                  A=(A32, (4, D, N)), Dskip=(Ds32, (4, D)), delta_bias=(bias32, (4, D)),
                  ln_g=(g32, (D,)), ln_b=(b32, (D,)), local=(loc32, (B, D)),
                  gate=(gate32, (B, C0)))
    L = (H // 2) * (W // 2)
    NC = -(-L // _CHUNK)
    proj_buf = torch.empty(B * 4 * L * (D + 2 * N), device=dev)
    chunk_sum = torch.empty(B * 4 * NC * D, device=dev)
    chunk_state = torch.empty(B * 4 * NC * D * N, device=dev)
    ybuf = torch.empty(B * H * W * D, device=dev)
    stats = torch.empty(B * H * W * 2, device=dev)
    og = torch.empty(B * H * W * D, device=dev, dtype=io)
    out = torch.empty_like(x_raw)
    fn = _build.declare(_build.load("ss2d_block"), "ss2d_block_forward", 20,
                        [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (x1, xs, x_raw, wz, wproj, A32, Ds32, bias32, g32, b32,
                              loc32, pw, gate32, out, proj_buf, chunk_sum,
                              chunk_state, ybuf, stats, og)),
            B, H, W, C0, D, N, _CHUNK, eps, _build.dtype_code(xs),
            _build.stream())
    _build.check(rc, "ss2d_block_forward")
    ss2d_image_block.launches += 1
    return out


def ss2d_compose(x1, xs_conv, x_raw, w_z, w_delta, w_b, w_c, A, Dskip, delta_bias,
                 ln_g, ln_b, local, proj_w, gate, eps):
    """The remat composition of the block (``_xla_compose`` with
    ``_merge_ln_gate_xla``, ss2d_fused.py:94-120), differentiable.

    The scan is :class:`ScanImageFn` where :func:`image_scan_vmem_ok` holds
    and the decimated :func:`selective_scan` elsewhere, with ys rounded to
    the io dtype; z comes from an io-dtype product; the gated product rounds
    to z's dtype before out_proj, whose sums are fp32."""
    B, H, W, D = xs_conv.shape
    N = A.shape[-1]
    io = xs_conv.dtype
    if image_scan_vmem_ok(H, W, D, N):
        ys = ScanImageFn.apply(xs_conv, w_delta, w_b, w_c, A, Dskip, delta_bias)
    else:
        xs = efficient_scan(xs_conv, 2)  # [B, K, L, D]
        dts, Bs, Cs = (xs @ w.to(io)[None] for w in (w_delta, w_b, w_c))
        ys = selective_scan(xs, dts, A, Bs, Cs, Dskip, delta_bias).to(io)
    z = x1 @ w_z.to(x1.dtype)
    yf = efficient_merge(ys, H, W, 2).float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf * yf).mean(dim=-1, keepdim=True) - mean * mean
    yn = (yf - mean) * torch.rsqrt(var + eps) * ln_g.float() + ln_b.float()
    out = yn * F.silu(z.float())
    if local is not None:
        out = out + local.float()[:, None, None, :]
    out = out.to(z.dtype)
    proj = out.float() @ proj_w.to(out.dtype).float()
    return (x_raw.float() + gate.float()[:, None, None, :] * proj).to(z.dtype)


class _SS2DBlockFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: autograd through :func:`ss2d_compose`."""

    @staticmethod
    def forward(ctx, eps, *args):
        ctx.eps = eps
        ctx.save_for_backward(*args)
        fn = _ss2d_block_cuda if args[1].is_cuda else _ss2d_block_plain
        return fn(*args, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        return (None, *remat_grads(lambda *a: ss2d_compose(*a, eps), ctx.saved_tensors,
                                   ctx.needs_input_grad[1:], g))


def _split_args(x1, xs_conv, x_raw, w_z, x_proj_weight, dt_projs_weight, A, Dskip,
                delta_bias, ln_g, ln_b, local, proj_w, gate, dt_rank, d_state):
    """The kernel's operands: the folded projections, and the product weights
    at the io dtype, as the JAX op casts them before its custom_vjp."""
    io = xs_conv.dtype
    w_delta, w_b, w_c = _derive_weights(x_proj_weight, dt_projs_weight, dt_rank, d_state)
    return (x1, xs_conv, x_raw, w_z.to(io), w_delta.to(io), w_b.to(io), w_c.to(io), A,
            Dskip, delta_bias, ln_g, ln_b, local, proj_w, gate)


def ss2d_image_block(x1, xs_conv, x_raw, w_z, x_proj_weight, dt_projs_weight, A,
                     Dskip, delta_bias, ln_g, ln_b, local, proj_w, gate,
                     dt_rank: int, d_state: int, eps: float = 1e-5):
    """``x_raw + gate * out_proj(LN(scan(xs_conv)) * silu(x1 @ w_z) + local)``.

    x1 [B,H,W,C0] modulated block input; xs_conv [B,H,W,D] post-silu scan
    input; x_raw [B,H,W,C0] residual; w_z [C0,D]; x_proj_weight [4,R+2N,D];
    dt_projs_weight [4,D,R]; A [4,D,N] (negative); Dskip, delta_bias [4,D];
    ln_g, ln_b [D]; local [B,D] or None; proj_w [D,C0]; gate [B,C0].
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Differentiable in every tensor argument.
    """
    return _SS2DBlockFn.apply(eps, *_split_args(
        x1, xs_conv, x_raw, w_z, x_proj_weight, dt_projs_weight, A, Dskip, delta_bias,
        ln_g, ln_b, local, proj_w, gate, dt_rank, d_state))


def ss2d_image_block_plain(x1, xs_conv, x_raw, w_z, x_proj_weight, dt_projs_weight, A,
                           Dskip, delta_bias, ln_g, ln_b, local, proj_w, gate,
                           dt_rank: int, d_state: int, eps: float = 1e-5):
    """The plain version of :func:`ss2d_image_block` on any device: the test
    oracle the kernel is held against."""
    return _ss2d_block_plain(*_split_args(
        x1, xs_conv, x_raw, w_z, x_proj_weight, dt_projs_weight, A, Dskip, delta_bias,
        ln_g, ln_b, local, proj_w, gate, dt_rank, d_state), eps)


ss2d_image_block.launches = 0
