"""MambaBlock attention half: ``x + gate * TransposedAttention(modulate(LN(x)))``.

Replaces the TPU kernel ``_attn_block_kernel``
(``founddiff_tpu/ops/attn_block.py:104``, via ``attn_block`` :422): LN with
adaLN modulation, the qkv 1x1 projection, the depthwise 3x3, the per-head
channel Gram with its L2 norms, the masked softmax with temperature,
project_out folded into one [C, C] matrix M per image, and the gated
residual.  CUDA tensors go to ``csrc/attn_block.cu``; CPU tensors to the
plain version :func:`attn_block_plain` (``attn_block_xla`` :343-390).  The
backward is ``_ab_bwd``'s (:412-416): autograd through the plain version
(:func:`.remat.remat_op`).
The weight operands (io-dtype casts, fp32 copies) are derived once per
parameter version (:mod:`._cache`), and the modulation and gate are read in
place when they are fp32 row-strided views (the adaLN chunks).

Weights keep the reference layout: qkv_w [3C, C, 1, 1], dw_w [3C, 1, 3, 3],
temperature [heads, 1, 1], proj_w [C, C, 1, 1].
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.norm import _ln_mod, _modulation
from founddiff_tpu_torch.ops.remat import remat_op
from founddiff_tpu_torch.utils import trace

_HEAD_DIM = 32  # MambaBlock builds heads = C // 32
# as csrc/attn_block.cu: the output pixels of one tile (rows, columns) and
# the tiles whose Gram partials one reduce block sums
_TILE = (8, 16)
_REDUCE = 16
# pixels in one partial product of transposed_attention's sums over pixels,
# so that a [32, 32] output's long sum is spread over many blocks of the card
_PIX_CHUNK = 1024


def attn_block_ok(H: int, W: int, C: int) -> bool:
    """Shapes the fused attention half takes: 32-channel heads and the
    8-row tiling of the JAX kernel's capability gate (attn_block.py:81-101)."""
    return C % _HEAD_DIM == 0 and C >= _HEAD_DIM and H % 8 == 0 and W % 8 == 0


def attn_block_route(H: int, W: int, C: int, cuda: bool = False, grad: bool = True) -> bool:
    """Whether a MambaBlock's attention half takes the fused kernel, read at
    each call from ``FOUNDDIFF_ATTN_BLOCK``: ``on`` takes it at every shape
    :func:`attn_block_ok` takes, ``off`` never.  ``auto`` (the default) takes
    it at C >= 128, as the JAX routing does (``founddiff_tpu/ops/
    attn_block.py:61-78``), and at every shape for a CUDA tensor (``cuda``)
    when autograd records nothing (``grad`` False).  The JAX routing keeps
    C < 128 plain because its TPU kernel pads the channels to 128; the CUDA
    kernel pads nothing.  A call that records a gradient stays on the JAX
    routing: the backward rematerialises through :func:`attn_block_plain`, so
    there the kernel's forward is work on top of the plain one.  The
    capability gate is the port's own (the JAX one adds a VMEM budget that
    every MambaBlock shape of the shipped sizes meets)."""
    mode = os.environ.get("FOUNDDIFF_ATTN_BLOCK", "auto")
    if mode == "off" or not attn_block_ok(H, W, C):
        return False
    return mode == "on" or C >= 128 or (cuda and not grad)


def transposed_attention(x2, qkv_w, dw_w, temperature, proj_w, heads: int):
    """Channel attention of an already-modulated x2 [B,H,W,C] (reference
    src/DADiff.py:252-285; JAX ``TransposedAttention`` blocks.py:453-503).

    The products take io-dtype operands with fp32 sums; u, the conv output,
    M and the output are rounded to the io dtype as in the TPU kernel.  Of
    the [2C, 2C] channel Gram only the entries read are formed: the q and k
    row norms and each head's [c, c] block of q^T k."""
    B, H, W, C = x2.shape
    io = x2.dtype
    ch = C // heads
    w = qkv_w[:, :, 0, 0].t().to(io).float()  # [C, 3C]
    u = (x2.float() @ w).to(io)  # [B, H, W, 3C]
    taps = dw_w.to(io).float()
    qkv = F.conv2d(u.float().permute(0, 3, 1, 2), taps, padding=1, groups=3 * C)
    qkv = qkv.permute(0, 2, 3, 1).to(io).float().reshape(B, H * W, 3 * C)
    # the pixel axis in S chunks of Pc (zero rows pad the last): each sum
    # over pixels below is S partial products, summed in fp32
    P = H * W
    S = -(-P // _PIX_CHUNK)
    Pc = -(-P // S)
    if S * Pc > P:
        qkv = F.pad(qkv, (0, 0, 0, S * Pc - P))
    q, k, v = qkv.reshape(B, S, Pc, 3, heads, ch).unbind(3)  # [B, S, Pc, h, c]
    qn = torch.linalg.vector_norm(q, dim=(1, 2)).clamp_min(1e-12)  # [B, h, c]
    kn = torch.linalg.vector_norm(k, dim=(1, 2)).clamp_min(1e-12)
    attn = (q.permute(0, 1, 3, 4, 2) @ k.permute(0, 1, 3, 2, 4)).sum(1)  # [B, h, c, d]
    attn = attn / (qn[..., None] * kn[:, :, None, :])
    attn = torch.softmax(attn * temperature.float(), dim=-1)
    pk = proj_w[:, :, 0, 0].t().float().reshape(heads, ch, C)  # [h, c, e]
    M = torch.einsum("hce,bhcd->bhde", pk, attn).reshape(B, C, C).to(io)
    out = (v.reshape(B, S, Pc, C) @ M.float()[:, None]).to(io)
    return out.reshape(B, S * Pc, C)[:, :P].reshape(B, H, W, C)


def attn_block_plain(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature,
                     proj_w, heads: int, eps: float = 1e-6):
    """The plain version of :func:`attn_block` on any device (``attn_block_xla``)."""
    B, H, W, C = x.shape
    x2 = _ln_mod(x.reshape(B, H * W, C), None, None, mod_scale, mod_shift, eps)
    out = transposed_attention(x2.reshape(B, H, W, C), qkv_w, dw_w, temperature,
                               proj_w, heads)
    return x + gate.to(x.dtype)[:, None, None, :] * out


def _rows32(t):
    """t [B, C] as fp32 rows with unit channel stride and its row stride: read
    in place when it is such a view (an adaLN chunk), else copied."""
    t = t.detach()
    if t.dtype == torch.float32 and t.dim() == 2 and t.stride(1) == 1:
        return t, t.stride(0)
    t = t.float().contiguous()
    return t, t.shape[-1]


def _workspace_bytes(B: int, H: int, W: int, C: int, io_size: int) -> int:
    """The kernel's workspace (csrc/attn_block.cu ``attn_block_forward``):
    256-byte aligned pieces for the LN statistics, v, the per-tile Gram
    partials, their sums by 16 tiles and M."""
    P, heads = B * H * W, C // _HEAD_DIM
    tiles = -(-H // _TILE[0]) * -(-W // _TILE[1])
    part = (_HEAD_DIM + 2) * _HEAD_DIM
    pieces = (P * 2 * 4, P * C * io_size, B * heads * tiles * part * 4,
              B * heads * -(-tiles // _REDUCE) * part * 4, B * C * C * io_size)
    return sum(-(-n // 256) * 256 for n in pieces)


@trace.traced("kernel.attn_block_forward")
def _attn_block_cuda(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature,
                     proj_w, heads: int, eps: float):
    B, H, W, C = x.shape
    if C != heads * _HEAD_DIM or not attn_block_ok(H, W, C):
        raise ValueError(f"attn_block takes 32-channel heads and H, W % 8 == 0; "
                         f"got {tuple(x.shape)} with {heads} heads")
    io = x.dtype
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    ms, mt, ldm = _modulation(mod_scale, mod_shift)
    g32, ldg = _rows32(gate)
    wqkv = _cache.derived(("attn_wqkv", io), (qkv_w,),
                          lambda: qkv_w.detach()[:, :, 0, 0].t().to(io).contiguous())  # [C, 3C]
    taps = _cache.derived(("attn_taps", io), (dw_w,),
                          lambda: dw_w.detach().reshape(3 * C, 9).t().to(io).contiguous())
    temp = _cache.f32(temperature.reshape(heads))
    pk = _cache.derived("attn_pk", (proj_w,),
                        lambda: proj_w.detach()[:, :, 0, 0].t().float().contiguous())
    dev = x.device
    _build.expect(dev, mod_scale=(ms, (B, C)), mod_shift=(mt, (B, C)), gate=(g32, (B, C)),
                  qkv_w=(wqkv, (C, 3 * C)), dw_w=(taps, (9, 3 * C)), temperature=(temp, (heads,)),
                  proj_w=(pk, (C, C)))
    ws = torch.empty(_workspace_bytes(B, H, W, C, x.element_size()), device=dev,
                     dtype=torch.uint8)
    out = torch.empty_like(x)
    fn = _build.kernel("attn_block", "attn_block_forward", 10,
                       [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (x, ms, mt, g32, wqkv, taps, temp, pk, out, ws)),
            ldm, ldg, B, H, W, C, eps, _build.dtype_code(x), _build.stream())
    _build.check(rc, "attn_block_forward")
    return out


_ATTN_BLOCK = remat_op("_AttnBlockFn", _attn_block_cuda, attn_block_plain, tensors=8)


def attn_block(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature, proj_w,
               heads: int, eps: float = 1e-6):
    """Fused ``x + gate * TransposedAttention(modulate(LN(x)))``; x [B,H,W,C],
    mod_scale/mod_shift/gate [B,C].  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  Differentiable in every tensor argument;
    a call that needs no gradient launches without the autograd Function."""
    return _ATTN_BLOCK(x, mod_scale, mod_shift, gate, qkv_w, dw_w, temperature, proj_w, heads,
                       eps)
