"""SS2D epilogue: EfficientMerge + LayerNorm + z gate + conditioning, and
the folded MambaBlock tail (the counterpart of
``founddiff_tpu/ops/ss2d_fused.py``):

    out = LN(merge(ys)) * gate_fn(z) + local                        (no fold)
    out = x_raw + gate * (round_io(LN(merge(ys)) * gate_fn(z) + local) @ proj_w)

``merge_ln_gate`` takes the joint [B, 4, L, C] direction sequences,
``merge_ln_gate_split`` the row-major dirs (0, 2) and the column-major dirs
(1, 3) as two [B, 2, L, C] arrays.  Both replace the TPU kernel
``_epilogue_kernel`` (ss2d_fused.py:32): CUDA tensors go to
``csrc/ss2d_epilogue.cu``, which reads either layout through strides and,
with fold, keeps og on chip in one launch (its tiling from
:func:`_fold_plan`), CPU tensors to the plain version
:func:`_merge_ln_gate_xla`.  The backward is
``_mlg_bwd``'s and ``_mlgs_bwd``'s (ss2d_fused.py:246-265, 341-362): autograd
through :func:`_merge_ln_gate_xla`, which is also the remat composition of
the fused SS2D block (``ss2d_block.ss2d_compose``).

Rounding follows the TPU kernel: ys and z are read at the io dtype (z's)
and taken to fp32; the LN statistics (one pass, ``E[y^2] - mean^2``), the
silu and the gate run in fp32; the gated product is rounded to the io
dtype, and with fold it meets out_proj at the io dtype with fp32 sums; the
result is at the io dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops.remat import remat_op
from founddiff_tpu_torch.ops.selective_scan import efficient_merge
from founddiff_tpu_torch.utils import trace


def _merge_ln_gate_xla(ys, z, scale, bias, local, H: int, W: int, eps: float,
                       gate_silu: bool = False, proj_w=None, gate=None, rx=None):
    """The plain composition (``_merge_ln_gate_xla``, ss2d_fused.py:94-120):
    ys [B, 4, L, C]; z [B, H, W, C]; with ``proj_w`` [C, Co] also ``gate``
    [B, Co] and ``rx`` [B, H, W, Co]."""
    yf = efficient_merge(ys, H, W, 2).float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = (yf * yf).mean(dim=-1, keepdim=True) - mean * mean
    yn = (yf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    zf = z.float()
    out = yn * (F.silu(zf) if gate_silu else zf)
    if local is not None:
        out = out + local.float()[:, None, None, :]
    out = out.to(z.dtype)
    if proj_w is not None:
        proj = out.float() @ proj_w.to(out.dtype).float()
        out = (rx.float() + gate.float()[:, None, None, :] * proj).to(z.dtype)
    return out


def _joint(rows, cols):
    """[B, 4, L, C] in direction order from rows (dirs 0, 2) and cols (1, 3)."""
    return torch.stack([rows[:, 0], cols[:, 0], rows[:, 1], cols[:, 1]], dim=1)


def _dense_rows(t):
    """t [B, 2, L, C] with each direction's [L, C] block contiguous; the
    batch and direction strides stay as they are, so the joint array's
    views reach the kernel without a copy."""
    C = t.shape[-1]
    return t if t.stride(-1) == 1 and t.stride(-2) == C else t.contiguous()


# The fold kernel's tilings (csrc/ss2d_epilogue.cu): (pixels a block,
# output channels a block, warps splitting K) for few pixels (at most
# _FEW_PIXELS: the 2x2 grids of a 16^2 slice, 4 per image) and for many.
_FEW_PIXELS = 64
_FOLD_TILES = {1: (16, 16, 8), 2: (64, 64, 1)}
_SMEM_MAX = 227 * 1024  # shared memory a block can use on the H100


def _fold_plan(P: int, C: int, Co: int, io_size: int):
    """``(plan, shared memory bytes)`` of the fold at P pixels: plan 1 (few
    pixels) or 2 (many) keeps og on chip in one launch, where the block's og
    rows [RM, C] and its weight slice [C, CN] fit (C padded to a multiple
    of 16 per K-splitting warp, the rows padded as the kernel pads them);
    else plan 0, og through device memory and a second launch."""
    plan = 1 if P <= _FEW_PIXELS else 2
    rm, cn, wk = _FOLD_TILES[plan]
    cp = -(-C // (16 * wk)) * (16 * wk)
    pad_a = 4 if io_size == 4 else 8
    smem = (rm * (cp + pad_a) + cp * (cn + 8)) * io_size + (wk * rm * cn * 4 if wk > 1 else 0)
    return (plan if smem <= _SMEM_MAX else 0), smem


@trace.traced("kernel.ss2d_epilogue_forward")
def _epilogue_cuda(rows, cols, z, scale, bias, local, proj_w, gate, rx, H, W, eps,
                   gate_silu):
    B, C = z.shape[0], z.shape[-1]
    io = z.dtype
    if H % 2 or W % 2:
        raise ValueError(f"the SS2D epilogue needs even H, W, got {H}x{W}")
    L = (H // 2) * (W // 2)
    rows, cols, z = _dense_rows(rows.to(io)), _dense_rows(cols.to(io)), z.contiguous()
    f32 = lambda t: None if t is None else t.detach().float().contiguous()
    g32, b32, loc32 = _cache.f32(scale), _cache.f32(bias), f32(local)
    fold = proj_w is not None
    Co = proj_w.shape[-1] if fold else C
    pw = _cache.derived(("epilogue_pw", io), (proj_w,),
                        lambda: proj_w.detach().to(io).contiguous()) if fold else None
    gate32, rx = (f32(gate), rx.to(io).contiguous()) if fold else (None, None)
    dev = z.device
    _build.expect(dev, rows=(rows, (B, 2, L, C)), cols=(cols, (B, 2, L, C)),
                  z=(z, (B, H, W, C)), scale=(g32, (C,)), bias=(b32, (C,)),
                  local=(loc32, (B, C)), proj_w=(pw, (C, Co)), gate=(gate32, (B, Co)),
                  rx=(rx, (B, H, W, Co)))
    plan = _fold_plan(B * H * W, C, Co, z.element_size())[0] if fold else 0
    out = torch.empty(B, H, W, Co, device=dev, dtype=io)
    og = torch.empty(B, H, W, C, device=dev, dtype=io) if fold and plan == 0 else None
    fn = _build.kernel("ss2d_epilogue", "ss2d_epilogue_forward", 13,
                       [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 4)
    rc = fn(*map(_build.ptr, (rows[:, 0], cols[:, 0], rows[:, 1], cols[:, 1], z, g32, b32,
                              loc32, pw, gate32, rx, out, og)),
            rows.stride(0), cols.stride(0), B, H, W, C, Co, eps, int(gate_silu), int(fold),
            plan, _build.dtype_code(z), _build.stream())
    _build.check(rc, "ss2d_epilogue_forward")
    return out


def _plain(rows, cols, z, scale, bias, local, proj_w, gate, rx, H, W, eps, gate_silu):
    return _merge_ln_gate_xla(_joint(rows, cols), z, scale, bias, local, H, W, eps,
                              gate_silu=gate_silu, proj_w=proj_w, gate=gate, rx=rx)


# backward: autograd through the joint sequences (``_mlgs_bwd`` stacks the
# split layout the same way)
_EPILOGUE = remat_op("_EpilogueFn", _epilogue_cuda, _plain, tensors=9)


def _check_fold(proj_w, gate, residual_x):
    if not (proj_w is None) == (gate is None) == (residual_x is None):
        raise ValueError("proj_w, gate and residual_x come together or not at all")


def merge_ln_gate(ys, z, scale, bias, local: Optional[torch.Tensor] = None, *, H: int,
                  W: int, eps: float = 1e-5, gate_silu: bool = False, proj_w=None, gate=None,
                  residual_x=None):
    """``LayerNorm(efficient_merge(ys)) * gate_fn(z) (+ local)``, gate_fn silu
    with ``gate_silu`` (pass the raw z), else the identity.

    ys [B, 4, (H/2)(W/2), C] (dirs 1 and 3 column-major); z [B, H, W, C];
    scale/bias [C]; local [B, C] or None.  ``proj_w [C, Co]`` + ``gate [B,
    Co]`` + ``residual_x [B, H, W, Co]`` fold the MambaBlock tail
    ``residual_x + gate * (out @ proj_w)``.  Even H, W.  CUDA tensors launch
    the kernel; CPU tensors take the plain version.  Differentiable in every
    tensor argument; a call that needs no gradient launches without the
    autograd Function."""
    _check_fold(proj_w, gate, residual_x)
    return _EPILOGUE(ys[:, 0::2], ys[:, 1::2], z, scale, bias, local, proj_w, gate, residual_x,
                     H, W, eps, gate_silu)


def merge_ln_gate_split(ys_rows, ys_cols, z, scale, bias, local: Optional[torch.Tensor] = None,
                        *, H: int, W: int, eps: float = 1e-5, gate_silu: bool = False,
                        proj_w=None, gate=None, residual_x=None):
    """:func:`merge_ln_gate` on the row-major dirs (0, 2) as ``ys_rows`` [B, 2,
    L, C] and the column-major dirs (1, 3) as ``ys_cols`` [B, 2, L, C], the
    layout of ``selective_scan_image``."""
    _check_fold(proj_w, gate, residual_x)
    return _EPILOGUE(ys_rows, ys_cols, z, scale, bias, local, proj_w, gate, residual_x, H, W,
                     eps, gate_silu)


def merge_ln_gate_plain(ys, z, scale, bias, local=None, *, H: int, W: int, eps: float = 1e-5,
                        gate_silu: bool = False, proj_w=None, gate=None, residual_x=None):
    """The plain version of :func:`merge_ln_gate` on any device."""
    return _merge_ln_gate_xla(ys, z, scale, bias, local, H, W, eps, gate_silu=gate_silu,
                              proj_w=proj_w, gate=gate, rx=residual_x)


def merge_ln_gate_split_plain(ys_rows, ys_cols, z, scale, bias, local=None, *, H: int, W: int,
                              eps: float = 1e-5, gate_silu: bool = False, proj_w=None,
                              gate=None, residual_x=None):
    """The plain version of :func:`merge_ln_gate_split` on any device."""
    return _plain(ys_rows, ys_cols, z, scale, bias, local, proj_w, gate, residual_x, H, W, eps,
                  gate_silu)
