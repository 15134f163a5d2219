"""Vanilla DDPM UNet (mirror of ``founddiff_tpu/models/vanilla_unet.py``):
the lucidrains baseline the reference bundles (src/denoising_diffusion_pytorch.py:283-410,
selected by ``original_ddim_ddpm=True``).

Two time-conditioned resnet blocks and a linear attention per scale, full
attention at the bottleneck, two skip concatenations per scale.  Module
names follow the lucidrains ``Unet`` state dict: ``downs.{i}.{0,1,2,3}`` are
(block1, block2, Residual(PreNorm(LinearAttention)), down conv), ``ups``
likewise, then ``mid_block1``, ``mid_attn``, ``mid_block2``,
``final_res_block`` and ``final_conv``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from founddiff_tpu_torch.models.blocks import (
    Attention,
    Block,
    Dense,
    Downsample,
    LinearAttention,
    PreNorm,
    Residual,
    SinusoidalPosEmb,
    Upsample,
    conv,
)


class TimeResnetBlock(nn.Module):
    """Two WSConv blocks, the first modulated by a SiLU-Linear time
    scale/shift (src/denoising_diffusion_pytorch.py:201-225; keys ``mlp.1``,
    ``block1``, ``block2``, ``res_conv``)."""

    def __init__(self, c_in: int, c_out: int, time_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), Dense(time_dim, 2 * c_out))
        self.block1 = Block(c_in, c_out, groups)
        self.block2 = Block(c_out, c_out, groups)
        self.res_conv = conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, time_emb):
        scale_shift = self.mlp(time_emb).chunk(2, dim=-1)
        h = self.block1(x, scale_shift=scale_shift)
        res = x if self.res_conv is None else self.res_conv(x)
        return self.block2(h, residual=res)


class VanillaUnet(nn.Module):
    """``forward(x [B,H,W,C] NHWC, time [B], x_self_cond=None)`` returns one
    tensor [B,H,W,C]: the predicted noise (no learned variance)."""

    def __init__(self, dim: int, dim_mults: Tuple[int, ...] = (1, 2, 4, 8), channels: int = 3,
                 self_condition: bool = False, resnet_block_groups: int = 8):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        time_dim = dim * 4
        g = resnet_block_groups
        self.init_conv = conv(channels * (2 if self_condition else 1), dim, 7)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), Dense(dim, time_dim), nn.GELU(),
                                      Dense(time_dim, time_dim))
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        block = lambda c_in, c_out: TimeResnetBlock(c_in, c_out, time_dim, g)
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            self.downs.append(nn.ModuleList([
                block(d_in, d_in), block(d_in, d_in),
                Residual(PreNorm(d_in, LinearAttention(d_in))),
                Downsample(d_in, d_out) if i < n - 1 else conv(d_in, d_out, 3),
            ]))
        mid = dims[-1]
        self.mid_block1 = block(mid, mid)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid)))
        self.mid_block2 = block(mid, mid)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            self.ups.append(nn.ModuleList([
                block(d_out + d_in, d_out), block(d_out + d_in, d_out),
                Residual(PreNorm(d_out, LinearAttention(d_out))),
                Upsample(d_out, d_in) if i < n - 1 else conv(d_out, d_in, 3),
            ]))
        self.final_res_block = block(2 * dim, dim)
        self.final_conv = conv(dim, channels, 1)

    def forward(self, x, time, x_self_cond=None):
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)
        x = self.init_conv(x)
        r = x
        t = self.time_mlp(time).to(x.dtype)  # no fp32 leak into the trunk under bf16
        skips = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            skips.append(x)
            x = attn(block2(x, t))
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, skips.pop()], dim=-1), t)
            x = block2(torch.cat([x, skips.pop()], dim=-1), t)
            x = up(attn(x))
        x = self.final_res_block(torch.cat([x, r], dim=-1), t)
        return self.final_conv(x)
