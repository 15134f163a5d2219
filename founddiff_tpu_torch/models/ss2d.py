"""SS2D and the adaLN-Zero MambaBlock (mirror of ``founddiff_tpu/models/ss2d.py``).

Routing is the TPU default of the JAX package (ss2d.py:267-317, 577-603):

- norm1 is :func:`layer_norm_modulated` at every block;
- with ``FOUNDDIFF_UNIFIED=1`` (off by default, as in the JAX package) norm1
  and the whole SS2D half run as one op, :func:`ss2d_mamba_block`, at every
  grid :func:`mamba_block_ok` takes (ss2d.py:219-265);
- every SS2D on an even grid of at least 4x4 runs :func:`ss2d_image_block`
  (delta/B/C projections, scan, LayerNorm, silu gate, conditioning,
  out_proj, adaLN gate and residual in one op), where the options allow the
  fold (v2 at step 2, a gate, neither bias nor dropout);
- on another even grid (a side of 2), and on every even grid the fold does
  not take, the epilogue route (ss2d.py:319-389): in_proj, the image scan
  where :func:`image_scan_vmem_ok` holds (else the fused-projection scan of
  the decimated sequences), then :func:`merge_ln_gate_split`
  (:func:`merge_ln_gate`) with out_proj, the adaLN gate and the residual
  folded in, or without the fold and then out_proj, dropout and the gated
  residual;
- on an odd grid (a slice side of 8 times an odd number makes the three
  deepest grids odd), with v0 or with another step the unfused route
  (:390-401): the fused-projection scan :func:`selective_scan_fused` of
  the direction sequences, the merge, :class:`LNorm`, the silu(z) gate,
  conditioning, out_proj, dropout and the gated residual;
- the attention half is :func:`attn_block` at C >= 128, else
  :func:`layer_norm_modulated` (norm2) + the plain TransposedAttention;
  with ``cross``, norm2 + :class:`CrossAttention` on the content embedding;
- with a ``mesh`` whose seq axis has more than one rank (set by
  :func:`founddiff_tpu_torch.models.unet.with_mesh`), every SS2D takes the
  unfused route with the sequence-sharded scan
  (:func:`seq_sharded_selective_scan`) in place of the fused-projection
  scan, and the fused block, the epilogue route and the unified op are off
  (ss2d.py:156-160, 199-207, 441-466).

CPU tensors take the same routes through the plain versions.  Parameter
names follow the reference (src/emamba2.py:404-751, src/DADiff.py:453-488).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from founddiff_tpu_torch.models.blocks import (
    CrossAttention,
    Dense,
    LNorm,
    TransposedAttention,
    conv_nhwc,
)
from founddiff_tpu_torch.ops import _cache
from founddiff_tpu_torch.ops.attn_block import attn_block, attn_block_route
from founddiff_tpu_torch.ops.experimental_unified import (
    mamba_block_ok,
    ss2d_mamba_block,
    unified_route,
)
from founddiff_tpu_torch.ops.norm import layer_norm_modulated
from founddiff_tpu_torch.ops.scan import (
    image_scan_vmem_ok,
    scan_image,
    scan_weights,
    selective_scan_fused,
)
from founddiff_tpu_torch.ops.selective_scan import (
    cross_merge_v0,
    cross_scan_v0,
    efficient_merge,
    efficient_scan,
)
from founddiff_tpu_torch.ops.ss2d_block import block_scan_ok, ss2d_image_block
from founddiff_tpu_torch.ops.ss2d_fused import merge_ln_gate, merge_ln_gate_split
from founddiff_tpu_torch.parallel.sequence import seq_sharded_selective_scan
from founddiff_tpu_torch.utils import trace

K_DIRS = 4


class SS2D(nn.Module):
    """2-D selective scan (reference src/emamba2.py:404-751) with the JAX
    options: ``forward_type`` "v2" (the step-``step_size`` decimated
    EfficientScan) or "v0" (the full four-direction scan), ``dt_rank``
    (default ``ceil(d_model / 16)``), the depthwise conv's ``d_conv`` and
    ``conv_bias``, ``use_bias`` on in_proj and out_proj, ``dropout`` after
    out_proj (train mode only) and ``context_dim``.

    The routes are the JAX package's (ss2d.py:199-401): v2 with step 2 on
    an even grid (and no seq mesh) takes the epilogue; with a gate, no bias
    and no dropout it folds out_proj, the gate and the residual in (the
    fused block where :func:`block_scan_ok`, else the epilogue route), and
    otherwise the epilogue runs without the fold, then out_proj, dropout and
    the gated residual.  v0, another step and odd grids take the unfused
    route: the fused-projection scan of :func:`cross_scan_v0`'s or
    :func:`efficient_scan`'s sequences, the merge, :class:`LNorm`, the
    silu(z) gate, conditioning, out_proj, dropout and the gated residual.
    ``FOUNDDIFF_SILU=kernel``, read at each call, moves the silu of the scan
    input into the fused block (ss2d.py:293-300)."""

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 context_dim: int = 256, dt_rank: Optional[int] = None, d_conv: int = 3,
                 conv_bias: bool = True, dropout: float = 0.0, use_bias: bool = False,
                 step_size: int = 2, forward_type: str = "v2"):
        super().__init__()
        if forward_type not in ("v0", "v2"):
            raise ValueError(f"forward_type is v0 or v2, got {forward_type!r}")
        D = int(ssm_ratio * d_model)
        R = dt_rank or -(-d_model // 16)
        self.d_inner, self.dt_rank, self.d_state = D, R, d_state
        self.d_conv, self.use_bias = d_conv, use_bias
        self.step_size, self.forward_type = step_size, forward_type
        self.in_proj = Dense(d_model, 2 * D, bias=use_bias)
        self.conv2d = nn.Conv2d(D, D, d_conv, padding=d_conv // 2, groups=D, bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * d_state, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, d_state))
        self.Ds = nn.Parameter(torch.ones(K_DIRS * D))
        self.out_norm = LNorm(D)
        self.out_proj = Dense(D, d_model, bias=use_bias)
        self.dropout = nn.Dropout(dropout)
        self.attn = nn.Sequential(Dense(context_dim, D, bias=False), nn.SiLU())
        self.mesh = None  # the sequence-parallel mesh (with_mesh)

    def seq_shards(self) -> int:
        """Ranks of the mesh's seq axis the scan's L is split over (1: none)."""
        return 1 if self.mesh is None else self.mesh.shape["seq"]

    def epilogue_ok(self, H: int, W: int) -> bool:
        """The JAX ``fuse_epilogue``: v2 with step 2 on an even grid, and no
        seq mesh (ss2d.py:199-206)."""
        return (self.forward_type == "v2" and self.step_size == 2 and H % 2 == 0
                and W % 2 == 0 and self.seq_shards() == 1)

    def fold_ok(self, gate) -> bool:
        """The JAX ``fold_proj``: a gate, no bias and no dropout (ss2d.py:216-218)."""
        return gate is not None and not self.use_bias and self.dropout.p == 0.0

    def unified_ok(self, H: int, W: int) -> bool:
        """What the unified op needs of this SS2D besides its grid
        (ss2d.py:228-235): the fused epilogue with the fold, a 3x3 conv."""
        return self.epilogue_ok(H, W) and self.fold_ok(True) and self.d_conv == 3

    def A(self) -> torch.Tensor:
        """``-exp(A_logs)`` [4, D, N] in fp32; without autograd, derived once
        per version of ``A_logs``, so that the kernels' weight caches see
        one tensor."""
        make = lambda: -torch.exp(self.A_logs.float()).reshape(K_DIRS, self.d_inner,
                                                                 self.d_state)
        if _cache.needs_grad(self.A_logs):
            return make()
        return _cache.derived("A", (self.A_logs,), make)

    def _in_proj(self, x1, half: int):
        """One half of in_proj at x1's dtype: 0 the scan input, 1 z."""
        D, w, b = self.d_inner, self.in_proj.weight, self.in_proj.bias
        part = slice(half * D, (half + 1) * D)
        return F.linear(x1, w[part].to(x1.dtype), None if b is None else b[part].to(x1.dtype))

    def _conv(self, xs):
        """The depthwise conv with the JAX SAME padding: (k - 1) // 2 before
        and k // 2 after, so an even kernel pads one more after."""
        k, w, b = self.d_conv, self.conv2d.weight, self.conv2d.bias
        if k % 2 == 0:
            xs = F.pad(xs, (0, 0, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2))
            return conv_nhwc(xs, w, b, groups=self.d_inner)
        return conv_nhwc(xs, w, b, padding=k // 2, groups=self.d_inner)

    @trace.traced("ss2d", device=True)
    def forward(self, x1, c=None, gate=None, residual=None):
        """x1 [B,H,W,C0] modulated input; c [B,1,context] content embedding or
        None; returns ``residual + gate * SS2D(x1)`` (gate [B, C0] and
        residual come together), or ``SS2D(x1)`` without them."""
        if (gate is None) != (residual is None):
            raise ValueError("gate and residual come together or not at all")
        B, H, W, _ = x1.shape
        D, N = self.d_inner, self.d_state
        local = self.attn(c)[:, 0] if c is not None else None
        A = self.A()
        Ds = self.Ds.reshape(K_DIRS, D)
        epilogue, fold = self.epilogue_ok(H, W), self.fold_ok(gate)
        xs = self._conv(self._in_proj(x1, 0))
        if epilogue and fold and block_scan_ok(H, W):
            silu_input = os.environ.get("FOUNDDIFF_SILU", "xla") == "kernel"
            return ss2d_image_block(
                x1, xs if silu_input else F.silu(xs), residual,
                w_z=self.in_proj.weight[D:].t(), x_proj_weight=self.x_proj_weight,
                dt_projs_weight=self.dt_projs_weight, A=A, Dskip=Ds,
                delta_bias=self.dt_projs_bias, ln_g=self.out_norm.weight,
                ln_b=self.out_norm.bias, local=local, proj_w=self.out_proj.weight.t(),
                gate=gate, dt_rank=self.dt_rank, d_state=N, eps=1e-5, silu_input=silu_input)
        xs = F.silu(xs)
        if epilogue:
            y = self._epilogue(x1, xs, local, A, Ds, gate if fold else None,
                               residual if fold else None)
            if fold:
                return y
        else:
            z = F.silu(self._in_proj(x1, 1))
            y = self.out_norm(self.scan_core(xs, A, Ds)) * z
            if local is not None:
                y = y + local[:, None, None, :]
        out = self.out_proj(y)
        if self.dropout.p > 0.0:  # flax's Dropout at rate 0 is the identity too
            out = self.dropout(out)
        if gate is None:
            return out
        return residual + gate.to(out.dtype)[:, None, None, :] * out

    def forward_unified(self, x, c, norm1, mod_scale, mod_shift, gate):
        """The whole SS2D half of the MambaBlock from its raw input x as one
        op, :func:`ss2d_mamba_block` (ss2d.py:228-265): ``x + gate *
        SS2D(modulate(norm1(x)))``."""
        D, N = self.d_inner, self.d_state
        return ss2d_mamba_block(
            x, norm1.weight, norm1.bias, mod_scale, mod_shift, self.in_proj.weight,
            self.conv2d.weight, self.conv2d.bias, self.x_proj_weight, self.dt_projs_weight,
            self.A(), self.Ds.reshape(K_DIRS, D),
            self.dt_projs_bias, self.out_norm.weight, self.out_norm.bias,
            self.attn(c)[:, 0] if c is not None else None, self.out_proj.weight, gate,
            d_inner=D, dt_rank=self.dt_rank, d_state=N)

    def sequences(self, xs):
        """The scan's [B, 4, L, D] direction sequences of xs [B, H, W, D]:
        :func:`cross_scan_v0` (v0, L = H W) or :func:`efficient_scan` at
        ``step_size`` (v2)."""
        if self.forward_type == "v0":
            return cross_scan_v0(xs)
        return efficient_scan(xs, self.step_size)

    def _scan_seq(self, xs, A, Ds):
        """The fused-projection scan of :meth:`sequences`: ys [B, 4, L, D] at
        xs's dtype (``_scan_core``, ss2d.py:422-475)."""
        return selective_scan_fused(self.sequences(xs), self.x_proj_weight,
                                    self.dt_projs_weight, A, Ds, self.dt_projs_bias,
                                    self.dt_rank, self.d_state)

    def scan_core(self, xs, A=None, Ds=None, merge: bool = True):
        """``_scan_core`` (ss2d.py:403-503): the scan of xs [B, H, W, D] (the
        fused-projection scan, or the sequence-sharded one under a seq mesh)
        and, with ``merge``, :func:`cross_merge_v0` or
        :func:`efficient_merge` at xs's dtype; ``merge=False`` returns the
        [B, 4, L, D] sequences."""
        A = self.A() if A is None else A
        Ds = self.Ds.reshape(K_DIRS, self.d_inner) if Ds is None else Ds
        ys = (self._scan_sharded(xs, A, Ds) if self.seq_shards() > 1
              else self._scan_seq(xs, A, Ds))
        if not merge:
            return ys.to(xs.dtype)
        H, W = xs.shape[1:3]
        if self.forward_type == "v0":
            return cross_merge_v0(ys, H, W).to(xs.dtype)
        return efficient_merge(ys, H, W, self.step_size).to(xs.dtype)

    def _epilogue(self, x1, xs, local, A, Ds, gate, residual):
        """Even grids with v2 and step 2 that the fused block does not take
        (ss2d.py:319-389): the scan, then one epilogue op; with a gate
        out_proj, the adaLN gate and the residual fold into it, without
        one the epilogue returns ``LN(y) * silu(z) + local``."""
        H, W = x1.shape[1:3]
        D, N, io = self.d_inner, self.d_state, x1.dtype
        z = self._in_proj(x1, 1)
        fold = {} if gate is None else dict(proj_w=self.out_proj.weight.t(), gate=gate.to(io),
                                            residual_x=residual)
        norm = (z, self.out_norm.weight, self.out_norm.bias, local)
        kw = dict(H=H, W=W, eps=1e-5, gate_silu=True, **fold)
        if image_scan_vmem_ok(H, W, D, N):
            w = scan_weights(io, self.x_proj_weight, self.dt_projs_weight, dt_rank=self.dt_rank,
                             d_state=N)
            ys = scan_image(xs, *w, A, Ds, self.dt_projs_bias)
            return merge_ln_gate_split(ys[:, 0::2], ys[:, 1::2], *norm, **kw)
        return merge_ln_gate(self._scan_seq(xs, A, Ds), *norm, **kw)

    def _scan_sharded(self, xs, A, Ds):
        """The sequence-sharded route's scan (ss2d.py:441-466): the x_dbl
        projection, the split into dts/B/C and the dt projection at xs's
        dtype, then :func:`seq_sharded_selective_scan` over the mesh's seq
        axis: ys [B, 4, L, D] fp32.  The batch is this data rank's own rows
        already, so it is not split again."""
        R, N = self.dt_rank, self.d_state
        seq = self.sequences(xs)
        x_dbl = torch.einsum("bkld,kcd->bklc", seq, self.x_proj_weight.to(seq.dtype))
        dts, Bs, Cs = torch.split(x_dbl, [R, N, N], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight.to(seq.dtype))
        return seq_sharded_selective_scan(seq, dts, A, Bs, Cs, Ds, self.dt_projs_bias,
                                          mesh=self.mesh)


class PatchMerging2D(nn.Module):
    """VMamba downsampling (reference src/emamba2.py:377-401): an odd H or W
    padded with zeros, each 2x2 neighbourhood concatenated as (0, 0), (1,
    0), (0, 1), (1, 1), ``norm`` (LayerNorm over 4 dim, eps 1e-5, in fp32
    as flax's) and ``reduction`` (Linear to ``out_dim``, default 2 dim, no
    bias)."""

    def __init__(self, dim: int, out_dim: int = -1):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, out_dim if out_dim > 0 else 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        x = F.layer_norm(x.float(), x.shape[-1:], self.norm.weight, self.norm.bias, 1e-5)
        return self.reduction(x)


class MambaBlock(nn.Module):
    """adaLN-Zero conditioned SS2D + channel-attention block
    (reference ``Mamba_block`` src/DADiff.py:453-488).  ``dropout`` goes to
    the SS2D (train mode only); ``cross`` replaces the channel attention by
    :class:`CrossAttention` on the content embedding after norm2, which
    never takes :func:`attn_block` (ss2d.py:577-606)."""

    def __init__(self, hidden_size: int, d_state: int, time_dim: int,
                 expand: float = 2.0, dropout: float = 0.0, cross: bool = False,
                 context_dim: int = 256):
        super().__init__()
        h = hidden_size
        self.hidden_size, self.cross = h, cross
        self.norm1 = nn.LayerNorm(h)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(time_dim, 6 * h))
        self.mamba = SS2D(h, d_state, ssm_ratio=expand, context_dim=context_dim,
                          dropout=dropout)
        self.attn_blk = (CrossAttention(h, context_dim=context_dim) if cross
                         else TransposedAttention(h, heads=max(1, h // 32)))

    @trace.traced("mamba_block", device=True)
    def forward(self, x, c, t):
        """x [B,H,W,h]; c [B,1,256]; t [B,time_dim]."""
        B, H, W, h = x.shape
        # fp32 modulation, as flax nn.Dense promotes the bf16 input to its
        # fp32 params (ss2d.py:546-554)
        lin = self.adaLN_modulation[1]
        mod = F.linear(F.silu(t).float(), lin.weight.float(), lin.bias.float())
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        if unified_route() and mamba_block_ok(H, W) and self.mamba.unified_ok(H, W):
            # the JAX conditions besides (ss2d.py:228-235) hold by construction:
            # norm1 comes first and the residual is x
            x = self.mamba.forward_unified(x, c, self.norm1, scale_msa, shift_msa, gate_msa)
        else:
            x1 = layer_norm_modulated(x, self.norm1.weight, self.norm1.bias, scale_msa,
                                      shift_msa, eps=1e-5)
            x = self.mamba(x1, c, gate_msa, residual=x)
        if not self.cross:
            args = (x, scale_mlp, shift_mlp, gate_mlp, *self.attn_blk.weights())
            if attn_block_route(H, W, h, x.is_cuda, _cache.needs_grad(*args)):
                return attn_block(*args, heads=self.attn_blk.heads, eps=1e-6)
        x2 = layer_norm_modulated(x, None, None, scale_mlp, shift_mlp, eps=1e-6)
        attn = self.attn_blk(x2, c) if self.cross else self.attn_blk(x2)
        # the gate rounds to the trunk dtype as in the fused kernels, so a
        # bf16 trunk stays bf16 past the C < 128 blocks
        return x + gate_mlp.to(x.dtype)[:, None, None, :] * attn
