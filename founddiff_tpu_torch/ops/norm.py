"""LayerNorm and LayerNorm + adaLN modulation.

``layer_norm`` replaces the TPU kernel ``_ln_kernel``
(``founddiff_tpu/ops/norm_pallas.py:23``): ``LN(x)`` over the last axis with
the one-pass fp32 statistics ``E[x^2] - mean^2`` and an optional affine,
the result at x's dtype.  ``layer_norm_modulated`` replaces
``_ln_mod_kernel`` (:123): the same, then ``* (1 + mod_scale_b) +
mod_shift_b``.  CUDA tensors go to ``csrc/ln_mod.cu`` (one entry each);
CPU tensors to the plain versions :func:`_ln` and :func:`_ln_mod`.  The
backwards are ``_fused_ln_bwd``'s (norm_pallas.py:87-96: autograd through
the two-pass :func:`layer_norm_two_pass`) and ``_fused_ln_mod_bwd``'s
(:196-204: autograd through :func:`_ln_mod`).

Host path: when no input needs a gradient the wrappers launch directly,
without an autograd Function; the fp32 copies of the affine are derived
once per parameter version (:mod:`._cache`), and the modulation is read in
place when it is an fp32 row-strided view (the adaLN chunks).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.remat import remat_grads


def layer_norm_two_pass(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm over the last axis with fp32 two-pass statistics
    (``_xla_layer_norm``, norm_pallas.py:72-79): the composition the
    backward of :func:`layer_norm` differentiates."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _ln(x2, scale, bias, eps):
    """Plain version of the LayerNorm kernel: x2 [R, C]; the one-pass
    ``E[x^2] - mean^2`` variance of ``_ln_kernel``."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x2.dtype)


_LN_TAIL = [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
_LN_MOD_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]


def _ln_cuda(x2, scale, bias, eps):
    R, C = x2.shape
    x2 = x2.contiguous()
    g, b = _cache.f32(scale), _cache.f32(bias)
    _build.expect(x2.device, scale=(g, (C,)), bias=(b, (C,)))
    out = torch.empty_like(x2)
    fn = _build.kernel("ln_mod", "ln_forward", 4, _LN_TAIL)
    rc = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(b), _build.ptr(out), R, C, eps,
            int(g is not None), _build.dtype_code(x2), _build.stream())
    _build.check(rc, "ln_forward")
    layer_norm.launches += 1
    return out


class _LnFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: autograd through :func:`layer_norm_two_pass`."""

    @staticmethod
    def forward(ctx, eps, x2, scale, bias):
        ctx.eps = eps
        ctx.save_for_backward(x2, scale, bias)
        return (_ln_cuda if x2.is_cuda else _ln)(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        return (None, *remat_grads(lambda *a: layer_norm_two_pass(*a, eps),
                                   ctx.saved_tensors, ctx.needs_input_grad[1:], g))


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """``LayerNorm(x)`` over the last axis, result at x's dtype; scale and
    bias [C] or both None.  CUDA tensors launch the kernel; CPU tensors take
    the plain version.  Differentiable in every tensor argument."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if _cache.needs_grad(x, scale, bias):
        return _LnFn.apply(eps, x2, scale, bias).reshape(shape)
    return (_ln_cuda if x.is_cuda else _ln)(x2, scale, bias, eps).reshape(shape)


def layer_norm_plain(x, scale=None, bias=None, eps: float = 1e-5):
    """The plain version of :func:`layer_norm` on any device."""
    return _ln(x.reshape(-1, x.shape[-1]), scale, bias, eps).reshape(x.shape)


layer_norm.launches = 0


def _ln_mod(x3, scale, bias, mod_scale, mod_shift, eps):
    """Plain version of the kernel: x3 [B, R, C]; the one-pass
    ``E[x^2] - mean^2`` variance of ``_ln_mod_kernel``."""
    xf = x3.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    y = y * (1.0 + mod_scale.float()[:, None, :]) + mod_shift.float()[:, None, :]
    return y.to(x3.dtype)


def _modulation(mod_scale, mod_shift):
    """mod_scale and mod_shift [B, C] as fp32 rows with one row stride: read
    in place when they are fp32 views with unit channel stride and a shared
    row stride (the chunks of the adaLN output), else copied."""
    ms, mt = mod_scale.detach(), mod_shift.detach()
    if (ms.dtype == mt.dtype == torch.float32 and ms.dim() == mt.dim() == 2
            and ms.stride(1) == mt.stride(1) == 1 and ms.stride(0) == mt.stride(0)):
        return ms, mt, ms.stride(0)
    ms, mt = ms.float().contiguous(), mt.float().contiguous()
    return ms, mt, ms.shape[-1]


def _ln_mod_cuda(x3, scale, bias, mod_scale, mod_shift, eps):
    B, R, C = x3.shape
    x3 = x3.contiguous()
    g, b = _cache.f32(scale), _cache.f32(bias)
    ms, mt, ldm = _modulation(mod_scale, mod_shift)
    _build.expect(x3.device, scale=(g, (C,)), bias=(b, (C,)), mod_scale=(ms, (B, C)),
                  mod_shift=(mt, (B, C)))
    out = torch.empty_like(x3)
    fn = _build.kernel("ln_mod", "ln_mod_forward", 6, _LN_MOD_TAIL)
    rc = fn(_build.ptr(x3), _build.ptr(g), _build.ptr(b), _build.ptr(ms),
            _build.ptr(mt), _build.ptr(out), B, R, C, ldm, eps, int(g is not None),
            _build.dtype_code(x3), _build.stream())
    _build.check(rc, "ln_mod_forward")
    layer_norm_modulated.launches += 1
    return out


class _LnModFn(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU tensors.
    Backward: autograd through :func:`_ln_mod`."""

    @staticmethod
    def forward(ctx, eps, x3, scale, bias, mod_scale, mod_shift):
        ctx.eps = eps
        ctx.save_for_backward(x3, scale, bias, mod_scale, mod_shift)
        fn = _ln_mod_cuda if x3.is_cuda else _ln_mod
        return fn(x3, scale, bias, mod_scale, mod_shift, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        return (None, *remat_grads(lambda *a: _ln_mod(*a, eps), ctx.saved_tensors,
                                   ctx.needs_input_grad[1:], g))


def layer_norm_modulated(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], mod_scale: torch.Tensor,
                         mod_shift: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``modulate(LayerNorm(x))``: x [B, ..., C]; mod_scale/mod_shift [B, C].
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Differentiable in every tensor argument."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    if _cache.needs_grad(x, scale, bias, mod_scale, mod_shift):
        return _LnModFn.apply(eps, x3, scale, bias, mod_scale, mod_shift).reshape(shape)
    fn = _ln_mod_cuda if x.is_cuda else _ln_mod
    return fn(x3, scale, bias, mod_scale, mod_shift, eps).reshape(shape)


def layer_norm_modulated_plain(x, scale, bias, mod_scale, mod_shift, eps: float = 1e-5):
    """The plain version of :func:`layer_norm_modulated` on any device."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    return _ln_mod(x3, scale, bias, mod_scale, mod_shift, eps).reshape(shape)


layer_norm_modulated.launches = 0
