"""Flash attention with its backward (the counterpart of
``founddiff_tpu/ops/attention_pallas.py``).

Three kernels, each with its plain PyTorch version beside it:

- ``flash_fwd`` replaces ``_fwd_kernel`` (attention_pallas.py:47, launched
  at :119): online-softmax attention that also returns the per-row
  logsumexp ``lse [G, Lq]`` (G = B * H) for the backward;
- ``flash_bwd_dq`` replaces ``_bwd_dq_kernel`` (:161, launched at :275):
  ``dq_i = scale * sum_j p_ij (do_i . v_j - D_i) k_j``;
- ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel`` (:201, launched at :293):
  ``dv_j = sum_i p_ij do_i`` and ``dk_j = scale * sum_i p_ij (do_i . v_j -
  D_i) q_i``;

with ``p_ij = exp(scale * q_i . k_j - lse_i)`` and ``D_i = rowsum(do_i *
o_i)``.  CUDA tensors go to ``csrc/flash_attention.cu``; CPU tensors to the
plain versions, which materialise the scores in fp32.  :class:`FlashAttentionFn`
is the ``custom_vjp`` of ``_flash_attention`` (:334-350).

Arithmetic as on the TPU: q, k, v, do are read at their dtype and widened to
fp32; the forward scales q before the product, the backward scales the
product; every sum is fp32; o, dq, dk, dv are rounded to the input dtype,
lse and D stay fp32.  Keys past ``Lk`` get exactly zero weight.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.utils import trace

HEAD_DIM = 32  # the kernels' one head dim: the vanilla UNet's 4 heads of 32


# --- plain versions ----------------------------------------------------------


def _scores(q, k, scale: float, scale_q: bool):
    """fp32 q . k^T over the last two axes, scaled as the kernel scales it."""
    qf, kf = q.float(), k.float()
    if scale_q:  # the forward: q * scale, then the product (attention_pallas.py:61)
        return (qf * scale) @ kf.transpose(-1, -2)
    return scale * (qf @ kf.transpose(-1, -2))  # the backward (:179, :221)


def flash_fwd_plain(q, k, v, scale: float):
    """Plain version of ``flash_fwd``: ``(o [B,H,Lq,d] at q's dtype, lse [G, Lq] fp32)``."""
    B, H, Lq, _ = q.shape
    s = _scores(q, k, scale, scale_q=True)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p @ v.float()) / l
    lse = (m + torch.log(l)).reshape(B * H, Lq)
    return o.to(q.dtype), lse


def _probs_and_dp(q, k, v, do, lse, dcap, scale):
    B, H, Lq, _ = q.shape
    p = torch.exp(_scores(q, k, scale, scale_q=False) - lse.reshape(B, H, Lq, 1))
    dov = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dov - dcap.reshape(B, H, Lq, 1))


def flash_bwd_dq_plain(q, k, v, do, lse, dcap, scale: float):
    """Plain version of ``flash_bwd_dq``: dq at q's dtype."""
    _, dp = _probs_and_dp(q, k, v, do, lse, dcap, scale)
    return (scale * (dp @ k.float())).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, dcap, scale: float):
    """Plain version of ``flash_bwd_dkv``: ``(dk, dv)`` at k's and v's dtypes."""
    p, dp = _probs_and_dp(q, k, v, do, lse, dcap, scale)
    dv = p.transpose(-1, -2) @ do.float()
    dk = scale * (dp.transpose(-1, -2) @ q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """softmax(q k^T * scale) v through the plain forward, differentiated by
    autograd: the plain path of :func:`flash_attention`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_fwd_plain(q, k, v, scale)[0]


# --- kernels -----------------------------------------------------------------


def _check(q, k, v, *more):
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"the flash kernels take head dim {HEAD_DIM}, got {d}")
    for name, t in (("k", k), ("v", v)) + more:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    _build.expect(q.device, k=(k, (B, H, Lk, d)), v=(v, (B, H, Lk, d)),
                  **{n: (t, (B, H, Lq, d)) for n, t in more})
    return B * H, Lq, Lk, d


def _rows(t, G, L, name, dev):
    t = t.detach().float().contiguous()
    _build.expect(dev, **{name: (t, (G, L))})
    return t


@trace.traced("kernel.flash_fwd")
def _flash_fwd_cuda(q, k, v, scale: float):
    G, Lq, Lk, d = _check(q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(G, Lq, device=q.device)
    fn = _build.kernel("flash_attention", "flash_fwd", 5,
                       [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, (q, k, v, o, lse)), G, Lq, Lk, d, scale, _build.dtype_code(q),
            _build.stream())
    _build.check(rc, "flash_fwd")
    return o, lse


def _bwd_operands(q, k, v, do, lse, dcap):
    G, Lq, Lk, d = _check(q, k, v, ("do", do))
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    return (q, k, v, do, _rows(lse, G, Lq, "lse", q.device),
            _rows(dcap, G, Lq, "dcap", q.device)), (G, Lq, Lk, d)


@trace.traced("kernel.flash_bwd_dq")
def _flash_bwd_dq_cuda(q, k, v, do, lse, dcap, scale: float):
    ops, dims = _bwd_operands(q, k, v, do, lse, dcap)
    dq = torch.empty_like(ops[0])
    fn = _build.kernel("flash_attention", "flash_bwd_dq", 7,
                       [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, ops + (dq,)), *dims, scale, _build.dtype_code(q), _build.stream())
    _build.check(rc, "flash_bwd_dq")
    return dq


@trace.traced("kernel.flash_bwd_dkv")
def _flash_bwd_dkv_cuda(q, k, v, do, lse, dcap, scale: float):
    ops, dims = _bwd_operands(q, k, v, do, lse, dcap)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    fn = _build.kernel("flash_attention", "flash_bwd_dkv", 8,
                       [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int])
    rc = fn(*map(_build.ptr, ops + (dk, dv)), *dims, scale, _build.dtype_code(q),
            _build.stream())
    _build.check(rc, "flash_bwd_dkv")
    return dk, dv


def flash_fwd(q, k, v, scale: float):
    """``(o [B,H,Lq,d] at q's dtype, lse [B*H, Lq] fp32)`` of softmax attention
    over q [B,H,Lq,d], k, v [B,H,Lk,d].  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    fn = _flash_fwd_cuda if q.is_cuda else flash_fwd_plain
    return fn(q, k, v, scale)


def flash_bwd_dq(q, k, v, do, lse, dcap, scale: float):
    """dq of :func:`flash_fwd` at cotangent ``do`` [B,H,Lq,d], given its
    ``lse`` and ``dcap = rowsum(do * o)`` [B*H, Lq] fp32.  CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    fn = _flash_bwd_dq_cuda if q.is_cuda else flash_bwd_dq_plain
    return fn(q, k, v, do, lse, dcap, scale)


def flash_bwd_dkv(q, k, v, do, lse, dcap, scale: float):
    """``(dk, dv)`` of :func:`flash_fwd`, operands as :func:`flash_bwd_dq`.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    fn = _flash_bwd_dkv_cuda if q.is_cuda else flash_bwd_dkv_plain
    return fn(q, k, v, do, lse, dcap, scale)


class FlashAttentionFn(torch.autograd.Function):
    """``_flash_attention``'s custom_vjp: forward ``flash_fwd`` (saves q, k, v,
    o and lse); backward ``D = rowsum(do * o)`` in fp32 from the stored o
    (plain PyTorch, as the JAX package computes it outside its kernels,
    attention_pallas.py:262-264), then ``flash_bwd_dq`` and ``flash_bwd_dkv``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        dcap = (do.float() * o.float()).sum(dim=-1).reshape(lse.shape)
        dq = flash_bwd_dq(q, k, v, do, lse, dcap, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dcap, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None):
    """softmax(q k^T * scale) v without the score matrix in device memory,
    forward or backward (``flash_attention``, attention_pallas.py:353-369):
    q [B,H,Lq,d], k, v [B,H,Lk,d] of one dtype; returns [B,H,Lq,d] at that
    dtype.  ``scale`` defaults to d^-0.5.  Differentiable in q, k and v."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttentionFn.apply(q, k, v, float(scale))


__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_plain", "flash_bwd_dkv",
           "flash_bwd_dkv_plain", "flash_bwd_dq", "flash_bwd_dq_plain", "flash_fwd",
           "flash_fwd_plain"]
