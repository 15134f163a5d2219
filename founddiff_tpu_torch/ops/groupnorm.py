"""GroupNorm + SiLU (+ residual) of the resnet blocks, with two routes.

Counterpart of ``founddiff_tpu/ops/groupnorm_pallas.py``.  The route is read
at call time from ``FOUNDDIFF_GN`` exactly as the JAX package reads it
(groupnorm_pallas.py:217): unset or ``"xla"`` gives the plain composition
(``_gn_silu_xla``, the default), anything else the two kernels:

- ``gn_stats`` replaces ``_stats_kernel`` (groupnorm_pallas.py:38, launched
  :83): per-channel sum and sum of squares of x [B, R, C] -> [B, 2, C] fp32;
- ``gn_apply`` replaces ``_apply_kernel`` (:50, launched :111):
  ``silu((x - mean) * rstd * g + b) (+ residual)`` with per-batch affine.

Between them, plain PyTorch turns the [B, 2, C] sums into group mean and
rstd with the arithmetic of ``_gn_silu_fwd`` (:98-107), as JAX does outside
its kernels.  CUDA tensors go to ``csrc/groupnorm.cu``; CPU tensors to the
plain versions :func:`gn_stats_plain` and :func:`gn_apply_plain`.  The
backward is ``_gn_silu_vjp_bwd``'s (:179-186): autograd through the plain
composition :func:`gn_silu_plain`.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.ops.remat import remat_grads

_TARGET_BLOCKS = 512  # stats blocks over the whole call: about 4 per SM


def gn_route() -> bool:
    """The kernel route: ``FOUNDDIFF_GN`` set and not ``"xla"``."""
    return os.environ.get("FOUNDDIFF_GN", "xla") != "xla"


# --- plain versions ----------------------------------------------------------


def gn_silu_plain(x, g, b, residual, groups: int, eps: float):
    """``silu(GroupNorm(x) * g + b) (+ residual)`` in fp32, cast back
    (``_gn_silu_xla``, groupnorm_pallas.py:150-166): x [B, H, W, C]; g, b
    fp32 of shape [C] or [B, C]."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * g.reshape(-1, 1, 1, C) + b.reshape(-1, 1, 1, C)
    y = F.silu(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def gn_stats_plain(x3):
    """Plain version of ``gn_stats``: x3 [B, R, C] -> [B, 2, C] fp32."""
    xf = x3.float()
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def gn_apply_plain(x3, mean, rstd, g, b, residual):
    """Plain version of ``gn_apply``: x3, residual [B, R, C]; mean, rstd, g,
    b [B, C] fp32; the result at x3's dtype."""
    col = lambda t: t.float()[:, None, :]
    y = (x3.float() - col(mean)) * col(rstd) * col(g) + col(b)
    y = y * torch.sigmoid(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x3.dtype)


def group_stats(sums, R: int, groups: int, eps: float):
    """[B, 2, C] channel sums over R rows -> per-channel (mean, rstd) [B, C]
    of their groups: ``var = E[x^2] - mean^2`` in fp32 (groupnorm_pallas.py:98-107)."""
    B, _, C = sums.shape
    cg = C // groups
    n = float(R * cg)
    gsum = sums.reshape(B, 2, groups, cg).sum(-1)
    mean_g = gsum[:, 0] / n
    var_g = gsum[:, 1] / n - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(cg, dim=-1), rstd_g.repeat_interleave(cg, dim=-1)


# --- kernels -----------------------------------------------------------------


def _check_x(x3):
    if x3.shape[-1] % 8:
        raise ValueError(f"the GroupNorm kernels take C % 8 == 0, got C={x3.shape[-1]}")
    _build.dtype_code(x3)


def _stats_chunks(B: int, R: int) -> int:
    """Row chunks per image of the stats kernel: about :data:`_TARGET_BLOCKS`
    blocks in all, so that one image of 262,144 rows still fills the card."""
    return max(1, min(R, -(-_TARGET_BLOCKS // B)))


def _gn_stats_cuda(x3):
    B, R, C = x3.shape
    _check_x(x3)
    x3 = x3.contiguous()
    nck = _stats_chunks(B, R)
    out = torch.empty(B, 2, C, device=x3.device)
    partial = torch.empty(B * nck * 2 * C, device=x3.device)
    fn = _build.declare(_build.load("groupnorm"), "gn_stats_forward", 3, [ctypes.c_int] * 5)
    rc = fn(_build.ptr(x3), _build.ptr(out), _build.ptr(partial), B, R, C, nck,
            _build.dtype_code(x3), _build.stream())
    _build.check(rc, "gn_stats_forward")
    gn_stats.launches += 1
    return out


def _gn_apply_cuda(x3, mean, rstd, g, b, residual):
    B, R, C = x3.shape
    _check_x(x3)
    x3 = x3.contiguous()
    f32 = lambda t: t.detach().float().contiguous()
    mean, rstd, g, b = f32(mean), f32(rstd), f32(g), f32(b)
    if residual is not None:
        if residual.dtype != x3.dtype:
            raise TypeError("residual must have x's dtype")
        residual = residual.contiguous()
    _build.expect(x3.device, mean=(mean, (B, C)), rstd=(rstd, (B, C)), g=(g, (B, C)),
                  b=(b, (B, C)), residual=(residual, (B, R, C)))
    out = torch.empty_like(x3)
    fn = _build.declare(_build.load("groupnorm"), "gn_apply_forward", 7, [ctypes.c_int] * 5)
    rc = fn(*map(_build.ptr, (x3, mean, rstd, g, b, residual, out)), B, R, C,
            int(residual is not None), _build.dtype_code(x3), _build.stream())
    _build.check(rc, "gn_apply_forward")
    gn_apply.launches += 1
    return out


def gn_stats(x3):
    """Per-channel ``[sum x, sum x^2]`` of x3 [B, R, C] over R: [B, 2, C]
    fp32.  CUDA tensors launch the kernel; CPU tensors take the plain version."""
    return (_gn_stats_cuda if x3.is_cuda else gn_stats_plain)(x3)


def gn_apply(x3, mean, rstd, g, b, residual=None):
    """``silu((x3 - mean) * rstd * g + b) (+ residual)`` with [B, C] fp32
    statistics and affine; ``residual`` None is never read.  CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    return (_gn_apply_cuda if x3.is_cuda else gn_apply_plain)(x3, mean, rstd, g, b, residual)


gn_stats.launches = 0
gn_apply.launches = 0


class GroupNormSiLUFn(torch.autograd.Function):
    """``_gn_silu``'s custom_vjp.  Forward: ``gn_stats``, the group
    statistics, ``gn_apply``.  Backward: autograd through
    :func:`gn_silu_plain` at the saved (x, g, b, residual)."""

    @staticmethod
    def forward(ctx, groups, eps, x, g, b, residual):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, g, b, residual)
        B, H, W, C = x.shape
        x3 = x.reshape(B, H * W, C)
        mean, rstd = group_stats(gn_stats(x3), H * W, groups, eps)
        r3 = None if residual is None else residual.reshape(B, H * W, C)
        return gn_apply(x3, mean, rstd, g, b, r3).reshape(B, H, W, C)

    @staticmethod
    def backward(ctx, grad):
        groups, eps = ctx.groups, ctx.eps
        return (None, None, *remat_grads(lambda *a: gn_silu_plain(*a, groups, eps),
                                         ctx.saved_tensors, ctx.needs_input_grad[2:], grad))


def group_norm_silu(x, scale, bias, residual=None, scale_shift=None, groups: int = 8,
                    eps: float = 1e-5):
    """``silu(GroupNorm(x) * scale + bias) (+ residual)``, x and residual
    [B, H, W, C] NHWC, scale and bias [C].  ``scale_shift``: an optional
    (mod_scale, mod_shift) pair [B, C], folded into the affine in fp32 as
    ``scale * (ms + 1)``, ``bias * (ms + 1) + mt`` (groupnorm_pallas.py:218-240)
    under autograd, so that its gradient reaches the time MLP.  The route
    is :func:`gn_route`'s."""
    B, C = x.shape[0], x.shape[-1]
    if C % groups:
        raise ValueError(f"C={C} is not a multiple of groups={groups}")
    g, b = scale.float(), bias.float()
    if scale_shift is not None:
        ms, mt = (t.float().reshape(B, C) for t in scale_shift)
        g, b = g * (ms + 1.0), b * (ms + 1.0) + mt
    if not gn_route():
        return gn_silu_plain(x, g, b, residual, groups, eps)
    return GroupNormSiLUFn.apply(groups, eps, x, g.expand(B, C), b.expand(B, C), residual)


__all__ = ["GroupNormSiLUFn", "gn_apply", "gn_apply_plain", "gn_route", "gn_silu_plain",
           "gn_stats", "gn_stats_plain", "group_norm_silu", "group_stats"]
