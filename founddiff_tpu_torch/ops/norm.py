"""LayerNorm and LayerNorm + adaLN modulation.

``layer_norm_modulated`` replaces the TPU kernel ``_ln_mod_kernel``
(``founddiff_tpu/ops/norm_pallas.py:123``): ``LN(x)`` with fp32 statistics,
an optional affine, then ``* (1 + mod_scale_b) + mod_shift_b``.  CUDA
tensors go to ``csrc/ln_mod.cu``; CPU tensors to the plain version
:func:`_ln_mod`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from founddiff_tpu_torch.ops import _build


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm over the last axis with fp32 statistics
    (``_xla_layer_norm``, norm_pallas.py:72-79)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


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


def _ln_mod_cuda(x3, scale, bias, mod_scale, mod_shift, eps):
    B, R, C = x3.shape
    x3 = x3.contiguous()
    f32 = lambda t: None if t is None else t.detach().float().contiguous()
    g, b, ms, mt = f32(scale), f32(bias), f32(mod_scale), f32(mod_shift)
    _build.expect(x3.device, scale=(g, (C,)), bias=(b, (C,)), mod_scale=(ms, (B, C)),
                  mod_shift=(mt, (B, C)))
    out = torch.empty_like(x3)
    fn = _build.declare(_build.load("ln_mod"), "ln_mod_forward", 6,
                        [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int])
    rc = fn(_build.ptr(x3), _build.ptr(g), _build.ptr(b), _build.ptr(ms),
            _build.ptr(mt), _build.ptr(out), B, R, C, eps, int(g is not None),
            _build.dtype_code(x3), _build.stream())
    _build.check(rc, "ln_mod_forward")
    layer_norm_modulated.launches += 1
    return out


def layer_norm_modulated(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], mod_scale: torch.Tensor,
                         mod_shift: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``modulate(LayerNorm(x))``: x [B, ..., C]; mod_scale/mod_shift [B, C].
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    fn = _ln_mod_cuda if x.is_cuda else _ln_mod
    return fn(x3, scale, bias, mod_scale, mod_shift, eps).reshape(shape)


def layer_norm_modulated_plain(x, scale, bias, mod_scale, mod_shift, eps: float = 1e-5):
    """The plain version of :func:`layer_norm_modulated` on any device."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    return _ln_mod(x3, scale, bias, mod_scale, mod_shift, eps).reshape(shape)


layer_norm_modulated.launches = 0
