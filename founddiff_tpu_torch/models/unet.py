"""FoundDiff denoiser UNet (mirror of ``founddiff_tpu/models/unet.py``).

Per-scale [MambaBlock -> ResnetBlock -> Downsample] encoder with d_state
4/8/16/32, a Resnet + Mamba mid block, a skip-concat decoder, and the
prompt-learned Dose-CLIP time conditioning (reference src/DADiff.py:530-836).
Module names follow the reference state dict: ``downs.{i}.{0,1,2}`` are
(ResnetBlock, MambaBlock, down conv), ``ups.{i}.{0,1,2}`` likewise.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn

from founddiff_tpu_torch.models.blocks import (
    Dense,
    Downsample,
    RandomOrLearnedSinusoidalPosEmb,
    ResnetBlock,
    SinusoidalPosEmb,
    Upsample,
    conv,
)
from founddiff_tpu_torch.models.ss2d import SS2D, MambaBlock


def with_mesh(module: nn.Module, mesh) -> nn.Module:
    """A copy of ``module`` whose every :class:`SS2D` carries ``mesh`` (the
    sequence-parallel mesh, ``founddiff_tpu/models/unet.py:61``): the
    counterpart of flax's ``model.clone(mesh=mesh)``.  The module tree is
    new; its parameters and buffers are the same tensors, so weights loaded
    into either (``from_jax_params``, ``load_torch``) are the other's."""
    new = copy.copy(module)
    new.__dict__["_parameters"] = dict(module._parameters)
    new.__dict__["_buffers"] = dict(module._buffers)
    new.__dict__["_modules"] = {k: None if m is None else with_mesh(m, mesh)
                                for k, m in module._modules.items()}
    if isinstance(new, SS2D):
        new.mesh = mesh
    return new


def time_mlp(dim: int, time_dim: int, learned_sinusoidal_cond: bool = False,
             random_fourier_features: bool = False,
             learned_sinusoidal_dim: int = 16) -> nn.Sequential:
    """The time MLP of both UNet families (keys ``time_mlp.{0,1,3}``): the
    embedding, Linear, GELU, Linear; the first Linear's width follows the
    embedding's."""
    if learned_sinusoidal_cond or random_fourier_features:
        emb = RandomOrLearnedSinusoidalPosEmb(learned_sinusoidal_dim, random_fourier_features)
        width = 2 * (learned_sinusoidal_dim // 2) + 1
    else:
        emb, width = SinusoidalPosEmb(dim), dim
    return nn.Sequential(emb, Dense(width, time_dim), nn.GELU(), Dense(time_dim, time_dim))


class Unet(nn.Module):
    """UNet backbone (src/DADiff.py:530-740).  ``dose_encoder``: the frozen
    Dose-CLIP tower, held here as the reference holds it (its state-dict keys
    are ``unet0.dose_encoder.*``) but never called by ``forward``; the
    samplers run it once per slice.

    ``init_dim`` (default ``dim``) is init_conv's width and the first
    level's; ``out_dim`` (default ``channels``, twice that with
    ``learned_variance``) final_conv's.  ``learned_sinusoidal_cond`` /
    ``random_fourier_features`` embed the time with
    :class:`RandomOrLearnedSinusoidalPosEmb` of ``learned_sinusoidal_dim``
    (the time MLP then takes ``learned_sinusoidal_dim + 1`` features), else
    with the sinusoidal embedding of ``dim`` (unet.py:80-95)."""

    def __init__(self, dim: int, dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
                 channels: int = 1, self_condition: bool = False,
                 resnet_block_groups: int = 8, condition: bool = False,
                 input_condition: bool = False, base_d_state: int = 4,
                 ssm_expand: float = 2.0, context_dim: int = 1024,
                 dose_encoder: Optional[nn.Module] = None, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, learned_variance: bool = False,
                 learned_sinusoidal_cond: bool = False, random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16):
        super().__init__()
        self.channels = channels
        self.self_condition = self_condition
        self.condition = condition
        self.context_dim = context_dim
        in_ch = channels * (1 + int(condition) + int(input_condition) + int(self_condition))
        time_dim = dim * 4
        g = resnet_block_groups
        init_dim = init_dim or dim
        self.init_conv = conv(in_ch, init_dim, 7)
        self.time_mlp = time_mlp(dim, time_dim, learned_sinusoidal_cond,
                                 random_fourier_features, learned_sinusoidal_dim)
        if condition:
            self.prompt = nn.Parameter(torch.empty(1, time_dim))
            self.text_mlp = nn.Sequential(Dense(context_dim, time_dim), nn.SiLU(),
                                          Dense(time_dim, time_dim))
            self.prompt_mlp = Dense(time_dim, time_dim)
        if dose_encoder is not None:
            self.dose_encoder = dose_encoder

        dims = [init_dim] + [dim * m for m in dim_mults]
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
        self.final_res_block = ResnetBlock(2 * init_dim, dim, g)
        self.final_conv = conv(dim, out_dim or channels * (2 if learned_variance else 1), 1)

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
                 dose_encoder: Optional[nn.Module] = None, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, learned_variance: bool = False):
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
                  context_dim=context_dim, init_dim=init_dim, out_dim=out_dim,
                  learned_variance=learned_variance)
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

    def clone(self, mesh=None) -> "UnetRes":
        """:func:`with_mesh`: this model, its weights shared, with every SS2D
        on ``mesh`` (the sequence-sharded scan where its seq axis has more
        than one rank)."""
        return with_mesh(self, mesh)
