"""FoundDiff denoiser UNet (mirror of ``founddiff_tpu/models/unet.py``).

Per-scale [MambaBlock -> ResnetBlock -> Downsample] encoder with d_state
4/8/16/32, a Resnet + Mamba mid block, a skip-concat decoder, and the
prompt-learned Dose-CLIP time conditioning (reference src/DADiff.py:530-836).
Module names follow the reference state dict: ``downs.{i}.{0,1,2}`` are
(ResnetBlock, MambaBlock, down conv), ``ups.{i}.{0,1,2}`` likewise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from founddiff_tpu_torch.models.blocks import (
    Dense,
    Downsample,
    ResnetBlock,
    SinusoidalPosEmb,
    Upsample,
    conv,
)
from founddiff_tpu_torch.models.ss2d import MambaBlock


class Unet(nn.Module):
    """UNet backbone (src/DADiff.py:530-740).  ``dose_encoder``: the frozen
    Dose-CLIP tower, held here as the reference holds it (its state-dict keys
    are ``unet0.dose_encoder.*``) but never called by ``forward``; the
    samplers run it once per slice."""

    def __init__(self, dim: int, dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
                 channels: int = 1, self_condition: bool = False,
                 resnet_block_groups: int = 8, condition: bool = False,
                 input_condition: bool = False, base_d_state: int = 4,
                 ssm_expand: float = 2.0, context_dim: int = 1024,
                 dose_encoder: Optional[nn.Module] = None):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        self.condition = condition
        self.context_dim = context_dim
        in_ch = channels * (1 + int(condition) + int(input_condition) + int(self_condition))
        time_dim = dim * 4
        g = resnet_block_groups
        self.init_conv = conv(in_ch, dim, 7)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), Dense(dim, time_dim),
                                      nn.GELU(), Dense(time_dim, time_dim))
        if condition:
            self.prompt = nn.Parameter(torch.empty(1, time_dim))
            self.text_mlp = nn.Sequential(Dense(context_dim, time_dim), nn.SiLU(),
                                          Dense(time_dim, time_dim))
            self.prompt_mlp = Dense(time_dim, time_dim)
        if dose_encoder is not None:
            self.dose_encoder = dose_encoder

        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)
        d_state = lambda level: base_d_state * 2 ** level
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            down = Downsample(d_in, d_out) if i < n - 1 else conv(d_in, d_out, 3)
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, g),
                MambaBlock(d_in, d_state(i), time_dim, ssm_expand),
                down,
            ]))
        mid = dims[-1]
        self.mid_block = ResnetBlock(mid, mid, g)
        self.mid_attn = MambaBlock(mid, d_state(n - 1), time_dim, ssm_expand)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            up = Upsample(d_out, d_in) if i < n - 1 else conv(d_out, d_in, 3)
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, g),
                MambaBlock(d_out, d_state(n - 1 - i), time_dim, ssm_expand),
                up,
            ]))
        self.final_res_block = ResnetBlock(2 * dim, dim, g)
        self.final_conv = conv(dim, channels, 1)

    def forward(self, x, time, dose_embedding=None, content_embedding=None,
                x_self_cond=None):
        """x [B,H,W,C_in] NHWC; time [B]; dose_embedding [B, context_dim];
        content_embedding [B, 1, 256]."""
        if self.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x[..., :self.channels])
            x = torch.cat([x_self_cond, x], dim=-1)
        x = self.init_conv(x)
        r = x
        t = self.time_mlp(time)
        c = None
        if self.condition:
            B = x.shape[0]
            if dose_embedding is None:
                dose_embedding = x.new_zeros(B, self.context_dim)
            pe = self.text_mlp(dose_embedding)
            pe = torch.softmax(pe, dim=1) * self.prompt.to(pe.dtype)
            t = t + self.prompt_mlp(pe)
            if content_embedding is None:
                content_embedding = x.new_zeros(B, 1, 256)
            c = content_embedding.to(x.dtype)
        t = t.to(x.dtype)

        skips = []
        for res, mamba, down in self.downs:
            x = mamba(x, c, t)
            x = res(x)
            skips.append(x)
            x = down(x)
        x = self.mid_block(x)
        x = self.mid_attn(x, c, t)
        for res, mamba, up in self.ups:
            x = res(x, skip=skips.pop())
            x = mamba(x, c, t)
            x = up(x)
        x = self.final_res_block(x, skip=r)
        return self.final_conv(x)


class UnetRes(nn.Module):
    """One or two UNets with per-objective time selection
    (src/DADiff.py:743-836); ``time`` is ``[acs[t]*T, bcs[t]*T]``."""

    def __init__(self, dim: int, dim_mults=(1, 2, 4, 8), channels: int = 1,
                 self_condition: bool = False, resnet_block_groups: int = 8,
                 num_unet: int = 1, condition: bool = False,
                 input_condition: bool = False, objective: str = "pred_res_noise",
                 test_res_or_noise: str = "res_noise", base_d_state: int = 4,
                 ssm_expand: float = 2.0, context_dim: int = 1024,
                 dose_encoder: Optional[nn.Module] = None):
        super().__init__()
        if num_unet not in (1, 2):
            raise ValueError("num_unet is 1 or 2")
        self.num_unet = num_unet
        self.objective = objective
        self.test_res_or_noise = test_res_or_noise
        kw = dict(dim=dim, dim_mults=tuple(dim_mults), channels=channels,
                  self_condition=self_condition, resnet_block_groups=resnet_block_groups,
                  condition=condition, input_condition=input_condition,
                  base_d_state=base_d_state, ssm_expand=ssm_expand,
                  context_dim=context_dim)
        self.unet0 = Unet(**kw, dose_encoder=dose_encoder)
        if num_unet == 2:
            self.unet1 = Unet(**kw)

    def forward(self, x, time, x_self_cond=None, dose_embedding=None,
                content_embedding=None):
        kw = dict(dose_embedding=dose_embedding, content_embedding=content_embedding,
                  x_self_cond=x_self_cond)
        if self.num_unet == 2:
            if self.test_res_or_noise == "res_noise":
                return [self.unet0(x, time[0], **kw), self.unet1(x, time[1], **kw)]
            if self.test_res_or_noise == "res":
                return [self.unet0(x, time[0], **kw), 0.0]
            if self.test_res_or_noise == "noise":
                return [0.0, self.unet1(x, time[1], **kw)]
            raise ValueError(self.test_res_or_noise)
        t = time[1] if self.objective == "pred_noise" else time[0]
        return [self.unet0(x, t, **kw)]
