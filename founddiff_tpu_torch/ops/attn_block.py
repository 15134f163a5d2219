"""MambaBlock attention half: ``x + gate * TransposedAttention(modulate(LN(x)))``.

Replaces the TPU kernel ``_attn_block_kernel``
(``founddiff_tpu/ops/attn_block.py:104``, via ``attn_block`` :422): LN with
adaLN modulation, the qkv 1x1 projection, the depthwise 3x3, the per-head
channel Gram with its L2 norms, the masked softmax with temperature,
project_out folded into one [C, C] matrix M per image, and the gated
residual.  CUDA tensors go to ``csrc/attn_block.cu``; CPU tensors to the
plain version :func:`attn_block_plain` (``attn_block_xla`` :343-390).  The
backward is ``_ab_bwd``'s (:412-416): autograd through the plain version.

Weights keep the reference layout: qkv_w [3C, C, 1, 1], dw_w [3C, 1, 3, 3],
temperature [heads, 1, 1], proj_w [C, C, 1, 1].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.ops.norm import _ln_mod
from founddiff_tpu_torch.ops.remat import remat_grads

_HEAD_DIM = 32  # MambaBlock builds heads = C // 32


def attn_block_ok(H: int, W: int, C: int) -> bool:
    """Shapes the fused attention half takes: 32-channel heads and the
    8-row tiling of the JAX kernel's capability gate (attn_block.py:81-101)."""
    return C % _HEAD_DIM == 0 and C >= _HEAD_DIM and H % 8 == 0 and W % 8 == 0


def attn_block_route(H: int, W: int, C: int) -> bool:
    """The JAX default routing (``FOUNDDIFF_ATTN_BLOCK=auto``): the fused
    kernel at C >= 128, the plain composition below."""
    return attn_block_ok(H, W, C) and C >= 128


def transposed_attention(x2, qkv_w, dw_w, temperature, proj_w, heads: int):
    """Channel attention of an already-modulated x2 [B,H,W,C] (reference
    src/DADiff.py:252-285; JAX ``TransposedAttention`` blocks.py:453-503).

    The products take io-dtype operands with fp32 sums; u, the conv output,
    M and the output are rounded to the io dtype as in the TPU kernel."""
    B, H, W, C = x2.shape
    io = x2.dtype
    ch = C // heads
    w = qkv_w[:, :, 0, 0].t().to(io).float()  # [C, 3C]
    u = (x2.float() @ w).to(io)  # [B, H, W, 3C]
    taps = dw_w.to(io).float()
    qkv = F.conv2d(u.float().permute(0, 3, 1, 2), taps, padding=1, groups=3 * C)
    qkv = qkv.permute(0, 2, 3, 1).to(io).float().reshape(B, H * W, 3 * C)
    qk = qkv[..., :2 * C]
    G = qk.transpose(1, 2) @ qk  # [B, 2C, 2C]
    diag = torch.diagonal(G, dim1=1, dim2=2)
    qn = torch.sqrt(diag[:, :C]).clamp_min(1e-12).reshape(B, heads, ch)
    kn = torch.sqrt(diag[:, C:]).clamp_min(1e-12).reshape(B, heads, ch)
    blocks = G[:, :C, C:]
    attn = torch.stack([blocks[:, i * ch:(i + 1) * ch, i * ch:(i + 1) * ch]
                        for i in range(heads)], dim=1)  # [B, h, c, d]
    attn = attn / (qn[..., None] * kn[:, :, None, :])
    attn = torch.softmax(attn * temperature.float(), dim=-1)
    pk = proj_w[:, :, 0, 0].t().float().reshape(heads, ch, C)  # [h, c, e]
    M = torch.einsum("hce,bhcd->bhde", pk, attn).reshape(B, C, C).to(io)
    out = (qkv[..., 2 * C:] @ M.float()).to(io)
    return out.reshape(B, H, W, C)


def attn_block_plain(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature,
                     proj_w, heads: int, eps: float = 1e-6):
    """The plain version of :func:`attn_block` on any device (``attn_block_xla``)."""
    B, H, W, C = x.shape
    x2 = _ln_mod(x.reshape(B, H * W, C), None, None, mod_scale, mod_shift, eps)
    out = transposed_attention(x2.reshape(B, H, W, C), qkv_w, dw_w, temperature,
                               proj_w, heads)
    return x + gate.to(x.dtype)[:, None, None, :] * out


def _gram_splits(B: int, heads: int, HW: int, sms: int) -> int:
    """Pixel runs per (image, head) of the partial-Gram pass: enough blocks
    for about four per SM of the card's ``sms``, at least 256 pixels each."""
    return max(1, min(-(-HW // 256), -(-4 * sms // (B * heads))))


def _attn_block_cuda(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature,
                     proj_w, heads: int, eps: float):
    B, H, W, C = x.shape
    if C != heads * _HEAD_DIM or not attn_block_ok(H, W, C):
        raise ValueError(f"attn_block takes 32-channel heads and H, W % 8 == 0; "
                         f"got {tuple(x.shape)} with {heads} heads")
    io = x.dtype
    x = x.contiguous()
    f32 = lambda t: t.detach().float().contiguous()
    ms, mt = f32(mod_scale), f32(mod_shift)
    gate_io = gate.to(io).contiguous()
    wqkv = qkv_w[:, :, 0, 0].t().to(io).contiguous()  # [C, 3C]
    taps = dw_w.reshape(3 * C, 9).t().to(io).contiguous()  # [9, 3C]
    temp = f32(temperature.reshape(heads))
    pk = f32(proj_w[:, :, 0, 0].t())  # [C_in, C_out]
    P = B * H * W
    dev = x.device
    splits = _gram_splits(B, heads, H * W,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    _build.expect(dev, mod_scale=(ms, (B, C)), mod_shift=(mt, (B, C)), gate=(gate_io, (B, C)),
                  qkv_w=(wqkv, (C, 3 * C)), dw_w=(taps, (9, 3 * C)), temperature=(temp, (heads,)),
                  proj_w=(pk, (C, C)))
    x2 = torch.empty(P * C, device=dev, dtype=io)
    u = torch.empty(P * 3 * C, device=dev, dtype=io)
    qkv = torch.empty(P * 3 * C, device=dev, dtype=io)
    part = torch.empty(B * heads * splits * (_HEAD_DIM + 2) * _HEAD_DIM, device=dev)
    M = torch.empty(B * C * C, device=dev, dtype=io)
    out = torch.empty_like(x)
    fn = _build.kernel("attn_block", "attn_block_forward", 14,
                       [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (x, ms, mt, gate_io, wqkv, taps, temp, pk, out, x2, u,
                              qkv, part, M)),
            B, H, W, C, splits, eps, _build.dtype_code(x), _build.stream())
    _build.check(rc, "attn_block_forward")
    attn_block.launches += 1
    return out


class _AttnBlockFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: autograd through :func:`attn_block_plain`."""

    @staticmethod
    def forward(ctx, heads, eps, *args):
        ctx.heads, ctx.eps = heads, eps
        ctx.save_for_backward(*args)
        fn = _attn_block_cuda if args[0].is_cuda else attn_block_plain
        return fn(*args, heads, eps)

    @staticmethod
    def backward(ctx, g):
        heads, eps = ctx.heads, ctx.eps
        return (None, None, *remat_grads(lambda *a: attn_block_plain(*a, heads, eps),
                                         ctx.saved_tensors, ctx.needs_input_grad[2:], g))


def attn_block(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature, proj_w,
               heads: int, eps: float = 1e-6):
    """Fused ``x + gate * TransposedAttention(modulate(LN(x)))``; x [B,H,W,C],
    mod_scale/mod_shift/gate [B,C].  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  Differentiable in every tensor argument."""
    return _AttnBlockFn.apply(heads, eps, x, mod_scale, mod_shift, gate, qkv_w, dw_w,
                              temperature, proj_w)


attn_block.launches = 0
