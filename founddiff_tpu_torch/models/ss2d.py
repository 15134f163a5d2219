"""SS2D and the adaLN-Zero MambaBlock (mirror of ``founddiff_tpu/models/ss2d.py``).

Routing is the TPU default of the JAX package (ss2d.py:267-317, 577-603):

- norm1 is :func:`layer_norm_modulated` at every block;
- with ``FOUNDDIFF_UNIFIED=1`` (off by default, as in the JAX package) norm1
  and the whole SS2D half run as one op, :func:`ss2d_mamba_block`, at every
  grid :func:`mamba_block_ok` takes (ss2d.py:219-265);
- every SS2D on an even grid of at least 4x4 runs :func:`ss2d_image_block`
  (delta/B/C projections, scan, LayerNorm, silu gate, conditioning,
  out_proj, adaLN gate and residual in one op);
- on another even grid (a side of 2) the epilogue route (ss2d.py:319-389):
  in_proj, the image scan where :func:`image_scan_vmem_ok` holds (else the
  fused-projection scan of the decimated sequences), then
  :func:`merge_ln_gate_split` (:func:`merge_ln_gate`) with out_proj, the
  adaLN gate and the residual folded in;
- on an odd grid (a slice side of 8 times an odd number makes the three
  deepest grids odd) the unfused route (:390-401): the fused-projection
  scan :func:`selective_scan_fused`, EfficientMerge, :class:`LNorm`, the
  silu(z) gate, conditioning, out_proj and the gated residual;
- the attention half is :func:`attn_block` at C >= 128, else
  :func:`layer_norm_modulated` (norm2) + the plain TransposedAttention.

CPU tensors take the same routes through the plain versions.  Parameter
names follow the reference (src/emamba2.py:404-751, src/DADiff.py:453-488).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from founddiff_tpu_torch.models.blocks import Dense, LNorm, TransposedAttention, conv_nhwc
from founddiff_tpu_torch.ops import _cache
from founddiff_tpu_torch.ops.attn_block import attn_block, attn_block_route
from founddiff_tpu_torch.ops.experimental_unified import (
    mamba_block_ok,
    ss2d_mamba_block,
    unified_route,
)
from founddiff_tpu_torch.ops.norm import layer_norm_modulated
from founddiff_tpu_torch.ops.scan import (
    _derive_weights,
    image_scan_vmem_ok,
    scan_image,
    selective_scan_fused,
)
from founddiff_tpu_torch.ops.selective_scan import efficient_merge, efficient_scan
from founddiff_tpu_torch.ops.ss2d_block import block_scan_ok, ss2d_image_block
from founddiff_tpu_torch.ops.ss2d_fused import merge_ln_gate, merge_ln_gate_split

K_DIRS = 4


class SS2D(nn.Module):
    """2-D selective scan, v2 decimated EfficientScan with step 2
    (reference src/emamba2.py:404-751)."""

    def __init__(self, d_model: int, d_state: int, ssm_ratio: float = 2.0,
                 context_dim: int = 256):
        super().__init__()
        D = int(ssm_ratio * d_model)
        R = -(-d_model // 16)
        self.d_inner, self.dt_rank, self.d_state = D, R, d_state
        self.in_proj = Dense(d_model, 2 * D, bias=False)
        self.conv2d = nn.Conv2d(D, D, 3, padding=1, groups=D, bias=True)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * d_state, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, d_state))
        self.Ds = nn.Parameter(torch.ones(K_DIRS * D))
        self.out_norm = LNorm(D)
        self.out_proj = Dense(D, d_model, bias=False)
        self.attn = nn.Sequential(Dense(context_dim, D, bias=False), nn.SiLU())

    def A(self) -> torch.Tensor:
        """``-exp(A_logs)`` [4, D, N] in fp32; without autograd, derived once
        per version of ``A_logs``, so that the kernels' weight caches see
        one tensor."""
        make = lambda: -torch.exp(self.A_logs.float()).reshape(K_DIRS, self.d_inner,
                                                                 self.d_state)
        if _cache.needs_grad(self.A_logs):
            return make()
        return _cache.derived("A", (self.A_logs,), make)

    def forward(self, x1, c, gate, residual):
        """x1 [B,H,W,C0] modulated input; c [B,1,context] content embedding;
        returns ``residual + gate * SS2D(x1)``."""
        B, H, W, _ = x1.shape
        D, N = self.d_inner, self.d_state
        local = self.attn(c)[:, 0] if c is not None else None
        A = self.A()
        Ds = self.Ds.reshape(K_DIRS, D)
        w_in = self.in_proj.weight
        xs = F.linear(x1, w_in[:D].to(x1.dtype))
        xs = F.silu(conv_nhwc(xs, self.conv2d.weight, self.conv2d.bias, padding=1,
                              groups=D))
        if block_scan_ok(H, W):
            return ss2d_image_block(
                x1, xs, residual, w_z=w_in[D:].t(), x_proj_weight=self.x_proj_weight,
                dt_projs_weight=self.dt_projs_weight, A=A, Dskip=Ds,
                delta_bias=self.dt_projs_bias, ln_g=self.out_norm.weight,
                ln_b=self.out_norm.bias, local=local, proj_w=self.out_proj.weight.t(),
                gate=gate, dt_rank=self.dt_rank, d_state=N, eps=1e-5)
        if H % 2 == 0 and W % 2 == 0:
            return self._epilogue(x1, xs, local, A, Ds, gate, residual)
        return self._unfused(x1, xs, local, A, Ds, gate, residual)

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

    def _scan_seq(self, xs, A, Ds):
        """The fused-projection scan of the decimated sequences:
        ys [B, 4, L, D] at xs's dtype (``_scan_core``, ss2d.py:422-475)."""
        return selective_scan_fused(efficient_scan(xs, 2), self.x_proj_weight,
                                    self.dt_projs_weight, A, Ds, self.dt_projs_bias,
                                    self.dt_rank, self.d_state)

    def _epilogue(self, x1, xs, local, A, Ds, gate, residual):
        """Even grids the fused block does not take (ss2d.py:319-389): the
        scan, then one epilogue op with out_proj, the adaLN gate and the
        residual folded in."""
        H, W = x1.shape[1:3]
        D, N, io = self.d_inner, self.d_state, x1.dtype
        z = F.linear(x1, self.in_proj.weight[D:].to(io))
        fold = dict(proj_w=self.out_proj.weight.t(), gate=gate.to(io),
                    residual_x=residual, H=H, W=W, eps=1e-5, gate_silu=True)
        norm = (z, self.out_norm.weight, self.out_norm.bias, local)
        if image_scan_vmem_ok(H, W, D, N):
            w = _derive_weights(self.x_proj_weight, self.dt_projs_weight, self.dt_rank, N)
            ys = scan_image(xs, *(t.to(io) for t in w), A, Ds, self.dt_projs_bias)
            return merge_ln_gate_split(ys[:, 0::2], ys[:, 1::2], *norm, **fold)
        return merge_ln_gate(self._scan_seq(xs, A, Ds), *norm, **fold)

    def _unfused(self, x1, xs, local, A, Ds, gate, residual):
        """Odd grids (ss2d.py:319-325, 390-401): the fused-projection scan of
        the padded decimated sequences, EfficientMerge, LNorm, the silu(z)
        gate, conditioning, out_proj and the gated residual."""
        H, W = x1.shape[1:3]
        z = F.silu(F.linear(x1, self.in_proj.weight[self.d_inner:].to(x1.dtype)))
        y = efficient_merge(self._scan_seq(xs, A, Ds), H, W, 2)
        y = self.out_norm(y) * z
        if local is not None:
            y = y + local[:, None, None, :]
        out = self.out_proj(y)
        return residual + gate.to(out.dtype)[:, None, None, :] * out


class MambaBlock(nn.Module):
    """adaLN-Zero conditioned SS2D + channel-attention block
    (reference ``Mamba_block`` src/DADiff.py:453-488)."""

    def __init__(self, hidden_size: int, d_state: int, time_dim: int,
                 expand: float = 2.0):
        super().__init__()
        h = hidden_size
        self.hidden_size = h
        self.norm1 = nn.LayerNorm(h)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(time_dim, 6 * h))
        self.mamba = SS2D(h, d_state, ssm_ratio=expand)
        self.attn_blk = TransposedAttention(h, heads=max(1, h // 32))

    def forward(self, x, c, t):
        """x [B,H,W,h]; c [B,1,256]; t [B,time_dim]."""
        B, H, W, h = x.shape
        # fp32 modulation, as flax nn.Dense promotes the bf16 input to its
        # fp32 params (ss2d.py:546-554)
        lin = self.adaLN_modulation[1]
        mod = F.linear(F.silu(t).float(), lin.weight.float(), lin.bias.float())
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        if unified_route() and mamba_block_ok(H, W):
            # the JAX conditions besides (ss2d.py:228-235) hold by construction:
            # norm1 comes first, the residual is x, the conv is 3x3, and
            # in_proj/out_proj have no bias and the block no dropout
            x = self.mamba.forward_unified(x, c, self.norm1, scale_msa, shift_msa, gate_msa)
        else:
            x1 = layer_norm_modulated(x, self.norm1.weight, self.norm1.bias, scale_msa,
                                      shift_msa, eps=1e-5)
            x = self.mamba(x1, c, gate_msa, residual=x)
        if attn_block_route(H, W, h):
            return attn_block(x, scale_mlp, shift_mlp, gate_mlp, *self.attn_blk.weights(),
                              heads=self.attn_blk.heads, eps=1e-6)
        x2 = layer_norm_modulated(x, None, None, scale_mlp, shift_mlp, eps=1e-6)
        # the gate rounds to the trunk dtype as in the fused kernels, so a
        # bf16 trunk stays bf16 past the C < 128 blocks
        return x + gate_mlp.to(x.dtype)[:, None, None, :] * self.attn_blk(x2)
