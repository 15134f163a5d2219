"""GroupNorm + SiLU (+ residual) of the resnet blocks, with two routes.

Counterpart of ``founddiff_tpu/ops/groupnorm_pallas.py``.  The route is read
at call time from ``FOUNDDIFF_GN`` exactly as the JAX package reads it
(groupnorm_pallas.py:217): unset or ``"xla"`` gives the plain composition
(``_gn_silu_xla``, the default), anything else the two kernels of
``csrc/groupnorm.cu``:

- ``gn_stats`` replaces ``_stats_kernel`` (groupnorm_pallas.py:38, launched
  :83) together with the group step that JAX runs between its kernels
  (:98-107) and the per-image affine fold (:234-240): x [B, R, C], the
  GroupNorm affine and the time scale/shift -> the apply pass's
  coefficients, a table [B, 2, C] fp32 of ``a = rstd * g`` and
  ``c = b - mean * a``;
- ``gn_apply`` replaces ``_apply_kernel`` (:50, launched :111):
  ``silu(x * a + c) (+ residual)``.

Host path: an epilogue on CUDA tensors is one C call (``gn_silu_forward``)
that launches both kernels, with no other PyTorch work than the output's
allocation.  With no gradient to record it is called directly; with one,
through :class:`GroupNormSiLUFn`, whose backward is ``_gn_silu_vjp_bwd``'s
(:179-186): autograd through the plain composition with the fold inside
(:func:`gn_silu_composed`), so the gradients reach the time MLP.  The affine
is read through :mod:`._cache`, the scale/shift in place when it is a pair
of fp32 row views (the ``.chunk`` of the time MLP's output).  The stats
kernel's scratch (its per-block partials, one ticket per image, which its
last block sets back to zero, and the epilogue's table) is cached per
device and stream (:func:`_workspace`): the calls on one stream run in
order, and a call on another stream takes that stream's own scratch, so no
two calls in flight share it.  CPU tensors take the plain versions
:func:`gn_stats_plain` and :func:`gn_apply_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.norm import _modulation
from founddiff_tpu_torch.ops.remat import remat_grads

_BLOCK_BYTES = 32 * 1024  # the least x one stats block streams
_MAX_BLOCKS = 264  # stats blocks over a call at most: 2 per SM

_STATS_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
_APPLY_TAIL = [ctypes.c_int] * 5
_SILU_TAIL = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]


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


def gn_silu_composed(x, scale, bias, residual, ms, mt, groups: int, eps: float):
    """The plain route: the scale/shift (ms, mt [B, C] or None) folded into
    the affine in fp32 (groupnorm_pallas.py:218-240), then
    :func:`gn_silu_plain`; under autograd, the backward of the kernel route."""
    B, C = x.shape[0], x.shape[-1]
    g, b = scale.float(), bias.float()
    if ms is not None:
        ms, mt = ms.float().reshape(B, C), mt.float().reshape(B, C)
        g, b = g * (ms + 1.0), b * (ms + 1.0) + mt
    return gn_silu_plain(x, g, b, residual, groups, eps)


def gn_stats_plain(x3, gamma, beta, ms, mt, groups: int, eps: float):
    """Plain version of ``gn_stats``: x3 [B, R, C]; gamma, beta [C]; ms, mt
    [B, C] or None -> the table [B, 2, C] fp32 of ``a = rstd * g`` and
    ``c = b - mean * a``, with the group mean and ``rstd = rsqrt(E[x^2] -
    mean^2 + eps)`` of ``_gn_silu_fwd`` (groupnorm_pallas.py:98-107) and
    ``g = gamma * (ms + 1)``, ``b = beta * (ms + 1) + mt``."""
    B, R, C = x3.shape
    cg = C // groups
    n = float(R * cg)
    xf = x3.float()
    sums = torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)
    gsum = sums.reshape(B, 2, groups, cg).sum(-1)
    mean = gsum[:, 0] / n
    rstd = torch.rsqrt(gsum[:, 1] / n - mean * mean + eps)
    mean, rstd = mean.repeat_interleave(cg, dim=-1), rstd.repeat_interleave(cg, dim=-1)
    g, b = gamma.float().expand(B, C), beta.float().expand(B, C)
    if ms is not None:
        m1 = ms.float().reshape(B, C) + 1.0
        g, b = g * m1, b * m1 + mt.float().reshape(B, C)
    a = rstd * g
    return torch.stack([a, b - mean * a], dim=1)


def gn_apply_plain(x3, table, residual):
    """Plain version of ``gn_apply``: x3, residual [B, R, C]; table [B, 2,
    C] fp32; ``silu(x3 * a + c) (+ residual)`` at x3's dtype."""
    y = x3.float() * table[:, 0, None, :] + table[:, 1, None, :]
    y = y * torch.sigmoid(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x3.dtype)


# --- kernels -----------------------------------------------------------------


def _check(x, groups: int) -> None:
    """What the kernels take: fp32 or bf16, C % 8 == 0, C at most 256
    16-byte vectors of V elements (a row to a block), and groups dividing C,
    at most 128 V (the last stats block's scratch)."""
    _build.dtype_code(x)
    C, vec = x.shape[-1], 16 // x.element_size()
    if C % 8 or C // vec > 256 or C % groups or groups > 128 * vec:
        raise ValueError(f"the GroupNorm kernels take C % 8 == 0, C <= {256 * vec} and "
                         f"groups dividing C, got C={C}, groups={groups}")


@functools.lru_cache(maxsize=None)
def _plan(B: int, R: int, C: int, groups: int, itemsize: int) -> Tuple[int, int, int]:
    """(stats blocks per image, ticket words, scratch words): each block
    streams at least ``_BLOCK_BYTES`` of x and the call runs at most about
    ``_MAX_BLOCKS`` blocks.  The scratch holds, in int32 words, the tickets
    (padded to 16 bytes), the epilogue's table and the partials."""
    nblk = max(1, min(-(-R * C * itemsize // _BLOCK_BYTES), -(-_MAX_BLOCKS // B)))
    tickets = -(-B // 4) * 4
    return nblk, tickets, tickets + 2 * B * C + B * nblk * 2 * groups


_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(device, stream: int, words: int) -> int:
    """The address of the stats kernel's scratch for ``stream``: made with
    zeroed tickets when missing or too small, else reused (the kernel leaves
    its tickets at zero)."""
    key = (device.index, stream)
    ws = _WORK.get(key)
    if ws is None or ws.numel() < words:
        ws = _WORK[key] = torch.zeros(words, dtype=torch.int32, device=device)
    return ws.data_ptr()


def _operands(x, gamma, beta, ms, mt, groups: int):
    """The affine and the scale/shift as the stats kernel reads them: fp32
    [C], and rows of one stride (0 and None without a scale/shift)."""
    B, C = x.shape[0], x.shape[-1]
    _check(x, groups)
    g, b = _cache.f32(gamma), _cache.f32(beta)
    ldm = 0
    if ms is not None:
        if ms.dim() != 2 or mt.dim() != 2:
            ms, mt = ms.reshape(B, C), mt.reshape(B, C)
        ms, mt, ldm = _modulation(ms, mt)
    _build.expect(x.device, gamma=(g, (C,)), beta=(b, (C,)), ms=(ms, (B, C)), mt=(mt, (B, C)))
    return g, b, ms, mt, ldm


def _residual(residual, x):
    if residual is None:
        return None
    if residual.dtype != x.dtype:
        raise TypeError("residual must have x's dtype")
    _build.expect(x.device, residual=(residual, x.shape))
    return residual.contiguous()


def _gn_stats_cuda(x3, gamma, beta, ms, mt, groups, eps):
    B, R, C = x3.shape
    x3 = x3.contiguous()
    g, b, ms, mt, ldm = _operands(x3, gamma, beta, ms, mt, groups)
    table = torch.empty(B, 2, C, device=x3.device)
    nblk, tickets, words = _plan(B, R, C, groups, x3.element_size())
    stream = _build.stream()
    ws = _workspace(x3.device, stream, words)
    fn = _build.kernel("groupnorm", "gn_stats_forward", 8, _STATS_TAIL)
    rc = fn(*map(_build.ptr, (x3, g, b, ms, mt, table)), ws + 4 * (tickets + 2 * B * C), ws,
            B, R, C, groups, nblk, ldm, eps, _build.dtype_code(x3), stream)
    _build.check(rc, "gn_stats_forward")
    gn_stats.launches += 1
    return table


def _gn_apply_cuda(x3, table, residual):
    B, R, C = x3.shape
    _check(x3, 1)
    x3 = x3.contiguous()
    if table.dtype != torch.float32:
        raise TypeError("the coefficient table must be fp32")
    table = table.detach().contiguous()
    residual = _residual(residual, x3)
    _build.expect(x3.device, table=(table, (B, 2, C)))
    out = torch.empty_like(x3)
    fn = _build.kernel("groupnorm", "gn_apply_forward", 4, _APPLY_TAIL)
    rc = fn(*map(_build.ptr, (x3, table, residual, out)), B, R, C, int(residual is not None),
            _build.dtype_code(x3), _build.stream())
    _build.check(rc, "gn_apply_forward")
    gn_apply.launches += 1
    return out


def _gn_silu_cuda(x, gamma, beta, residual, ms, mt, groups, eps):
    """One epilogue in one C call: the stats kernel writes its table into
    the stream's scratch, the apply kernel reads it."""
    B, H, W, C = x.shape
    x = x.contiguous()
    g, b, ms, mt, ldm = _operands(x, gamma, beta, ms, mt, groups)
    residual = _residual(residual, x)
    out = torch.empty_like(x)
    nblk, tickets, words = _plan(B, H * W, C, groups, x.element_size())
    stream = _build.stream()
    ws = _workspace(x.device, stream, words)
    table = ws + 4 * tickets
    fn = _build.kernel("groupnorm", "gn_silu_forward", 10, _SILU_TAIL)
    rc = fn(*map(_build.ptr, (x, g, b, ms, mt, residual, out)), table, table + 8 * B * C, ws,
            B, H * W, C, groups, nblk, ldm, int(residual is not None), eps,
            _build.dtype_code(x), stream)
    _build.check(rc, "gn_silu_forward")
    gn_stats.launches += 1
    gn_apply.launches += 1
    return out


def gn_stats(x3, gamma, beta, ms=None, mt=None, groups: int = 8, eps: float = 1e-5):
    """The apply pass's coefficient table [B, 2, C] fp32 of x3 [B, R, C],
    the GroupNorm affine gamma, beta [C] and the scale/shift ms, mt [B, C]
    (or None).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    fn = _gn_stats_cuda if x3.is_cuda else gn_stats_plain
    return fn(x3, gamma, beta, ms, mt, groups, eps)


def gn_apply(x3, table, residual=None):
    """``silu(x3 * table[:, 0] + table[:, 1]) (+ residual)`` at x3's dtype;
    ``residual`` None is never read.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    return (_gn_apply_cuda if x3.is_cuda else gn_apply_plain)(x3, table, residual)


gn_stats.launches = 0
gn_apply.launches = 0


def _gn_silu(x, gamma, beta, residual, ms, mt, groups, eps):
    """The kernel route's forward: one C call on CUDA tensors; on CPU
    tensors ``gn_stats`` then ``gn_apply`` (their plain versions)."""
    if x.is_cuda:
        return _gn_silu_cuda(x, gamma, beta, residual, ms, mt, groups, eps)
    B, H, W, C = x.shape
    x3 = x.reshape(B, H * W, C)
    table = gn_stats(x3, gamma, beta, ms, mt, groups, eps)
    r3 = None if residual is None else residual.reshape(B, H * W, C)
    return gn_apply(x3, table, r3).reshape(B, H, W, C)


class GroupNormSiLUFn(torch.autograd.Function):
    """``_gn_silu``'s custom_vjp on the unfolded operands.  Forward: the
    kernel route.  Backward: autograd through :func:`gn_silu_composed` at the
    saved (x, scale, bias, residual, ms, mt)."""

    @staticmethod
    def forward(ctx, groups, eps, x, scale, bias, residual, ms, mt):
        ctx.groups, ctx.eps = groups, eps
        ctx.save_for_backward(x, scale, bias, residual, ms, mt)
        return _gn_silu(x, scale, bias, residual, ms, mt, groups, eps)

    @staticmethod
    def backward(ctx, grad):
        groups, eps = ctx.groups, ctx.eps
        return (None, None, *remat_grads(lambda *a: gn_silu_composed(*a, groups, eps),
                                         ctx.saved_tensors, ctx.needs_input_grad[2:], grad))


def group_norm_silu(x, scale, bias, residual=None, scale_shift=None, groups: int = 8,
                    eps: float = 1e-5):
    """``silu(GroupNorm(x) * scale + bias) (+ residual)``, x and residual
    [B, H, W, C] NHWC, scale and bias [C].  ``scale_shift``: an optional
    (mod_scale, mod_shift) pair [B, C], folded into the affine in fp32 as
    ``scale * (ms + 1)``, ``bias * (ms + 1) + mt`` (groupnorm_pallas.py:218-240);
    its gradient reaches the time MLP.  The route is :func:`gn_route`'s."""
    C = x.shape[-1]
    if C % groups:
        raise ValueError(f"C={C} is not a multiple of groups={groups}")
    ms, mt = (None, None) if scale_shift is None else scale_shift
    if not gn_route():
        return gn_silu_composed(x, scale, bias, residual, ms, mt, groups, eps)
    if _cache.needs_grad(x, scale, bias, residual, ms, mt):
        return GroupNormSiLUFn.apply(groups, eps, x, scale, bias, residual, ms, mt)
    return _gn_silu(x, scale, bias, residual, ms, mt, groups, eps)


__all__ = ["GroupNormSiLUFn", "gn_apply", "gn_apply_plain", "gn_route", "gn_silu_composed",
           "gn_silu_plain", "gn_stats", "gn_stats_plain", "group_norm_silu"]
