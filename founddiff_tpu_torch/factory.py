"""Build the serving and training paths from a Config (mirror of
``founddiff_tpu/factory.py``): the FoundDiff path (CLIPIQA tower + UnetRes +
ResidualDiffusion) or, with ``original_ddim_ddpm``, the vanilla lucidrains
path (VanillaUnet + GaussianDiffusion).

Weights are drawn on the CPU from an explicit ``torch.Generator`` with the
reference's init distributions (torch-default uniform for Linear/Conv, S4D
for the scan, zero adaLN), then moved to ``device``, so one seed gives the
same weights on every device.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion
from founddiff_tpu_torch.models.blocks import (
    ChanLayerNorm,
    RandomOrLearnedSinusoidalPosEmb,
    TransposedAttention,
)
from founddiff_tpu_torch.models.clip import (CLIP, AttentionPool2d, PromptLearner,
                                            VisionTransformer, _MHAWeights)
from founddiff_tpu_torch.models.founddiff import FoundDiffDenoiser
from founddiff_tpu_torch.models.ss2d import SS2D, MambaBlock
from founddiff_tpu_torch.models.unet import Unet, UnetRes
from founddiff_tpu_torch.models.vanilla_unet import VanillaUnet
from founddiff_tpu_torch.utils.device import resolve


def _fill(t: torch.Tensor, gen: torch.Generator, kind: str, a: float = 0.0,
          b: float = 1.0) -> None:
    src = torch.empty(t.shape)
    if kind == "uniform":
        src.uniform_(a, b, generator=gen)
    else:
        src.normal_(a, b, generator=gen)
    with torch.no_grad():
        t.copy_(src)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    """Reference init distributions (models/init.py, ss2d.py:41-68, clip.py)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = mod.weight[0].numel() ** -0.5
            _fill(mod.weight, gen, "uniform", -bound, bound)
            if mod.bias is not None:
                _fill(mod.bias, gen, "uniform", -bound, bound)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, SS2D):
            D, R, N = mod.d_inner, mod.dt_rank, mod.d_state
            _fill(mod.x_proj_weight, gen, "uniform", -D ** -0.5, D ** -0.5)
            _fill(mod.dt_projs_weight, gen, "uniform", -R ** -0.5, R ** -0.5)
            u = torch.empty(mod.dt_projs_bias.shape).uniform_(generator=gen)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
            mod.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            a = torch.arange(1, N + 1, dtype=torch.float32).log()
            mod.A_logs.copy_(a.expand_as(mod.A_logs))
            mod.Ds.fill_(1.0)
        elif isinstance(mod, TransposedAttention):
            mod.temperature.fill_(1.0)
        elif isinstance(mod, RandomOrLearnedSinusoidalPosEmb):
            _fill(mod.weights, gen, "normal", 0.0, 1.0)
        elif isinstance(mod, ChanLayerNorm):
            mod.g.fill_(1.0)
        elif isinstance(mod, AttentionPool2d):
            emb = mod.positional_embedding.shape[1]
            _fill(mod.positional_embedding, gen, "normal", 0.0, emb ** -0.5)
        elif isinstance(mod, _MHAWeights):
            d = mod.in_proj_weight.shape[1]
            _fill(mod.in_proj_weight, gen, "uniform", -d ** -0.5, d ** -0.5)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, CLIP):
            width = mod.positional_embedding.shape[1]
            _fill(mod.positional_embedding, gen, "normal", 0.0, 0.01)
            _fill(mod.text_projection, gen, "normal", 0.0, width ** -0.5)
            mod.logit_scale.fill_(math.log(1 / 0.07))
        elif isinstance(mod, VisionTransformer):
            scale = mod.class_embedding.shape[0] ** -0.5
            for t in (mod.class_embedding, mod.positional_embedding, mod.proj):
                _fill(t, gen, "normal", 0.0, scale)
        elif isinstance(mod, nn.Embedding):  # CLIP's token embedding
            _fill(mod.weight, gen, "normal", 0.0, 0.02)
        elif isinstance(mod, PromptLearner):
            _fill(mod.ctx, gen, "normal", 0.0, 0.02)
            _fill(mod.token_prefix, gen, "normal", 0.0, 0.01)
            _fill(mod.token_suffix, gen, "normal", 0.0, 0.01)
        elif isinstance(mod, Unet) and hasattr(mod, "prompt"):
            _fill(mod.prompt, gen, "uniform", 0.0, 1.0)
    for mod in model.modules():
        if isinstance(mod, MambaBlock):  # adaLN-Zero (src/DADiff.py:473-474)
            mod.adaLN_modulation[1].weight.zero_()
            mod.adaLN_modulation[1].bias.zero_()


# The FoundDiff fields the JAX factory does not pass on, so its UNet always
# has their defaults (founddiff_tpu/factory.py:33-46, models/unet.py:227-241,
# models/founddiff.py:28-63): the port builds the same model from one Config.
# The no-tower UnetRes takes resnet_block_groups and learned_variance.
JAX_FIXED = {"base_d_state": 4, "ssm_expand": 2.0, "resnet_block_groups": 8,
             "learned_variance": False}


def build_denoiser(config: Config,
                   clip_overrides=()) -> Union[FoundDiffDenoiser, UnetRes, VanillaUnet]:
    """The vanilla UNet, FoundDiff (``use_dose_encoder``) or, without the
    tower, a ``UnetRes`` whose dose/content embeddings are zeros
    (``founddiff_tpu/factory.py:32-59``; the JAX factory passes
    ``resnet_block_groups`` and ``learned_variance`` on to that one, and to
    the vanilla UNet)."""
    m = config.model
    if m.original_ddim_ddpm:
        return VanillaUnet(dim=m.dim, dim_mults=tuple(m.dim_mults), channels=m.channels,
                           self_condition=m.self_condition,
                           resnet_block_groups=m.resnet_block_groups,
                           learned_variance=m.learned_variance)
    fixed = dict(JAX_FIXED)
    if not m.use_dose_encoder:
        fixed.pop("resnet_block_groups")
        fixed.pop("learned_variance")
    ignored = {k: getattr(m, k) for k, v in fixed.items() if getattr(m, k) != v}
    kind = "FoundDiff" if m.use_dose_encoder else "UnetRes"
    if ignored:
        warnings.warn(f"build: the JAX package builds {kind} with "
                      + ", ".join(f"{k}={fixed[k]}" for k in ignored) + " whatever the "
                      "Config says; ignoring " + ", ".join(f"{k}={v}" for k, v in ignored.items())
                      + f" (construct {kind} directly for other values)", stacklevel=2)
    kw = dict(dim=m.dim, dim_mults=tuple(m.dim_mults), channels=m.channels,
              num_unet=m.num_unet, condition=m.condition, input_condition=m.input_condition,
              self_condition=m.self_condition, objective=m.objective,
              test_res_or_noise=m.test_res_or_noise,
              **{k: v for k, v in fixed.items() if k != "learned_variance"})
    if not m.use_dose_encoder:
        return UnetRes(resnet_block_groups=m.resnet_block_groups,
                       learned_variance=m.learned_variance, **kw)
    return FoundDiffDenoiser(clip_backbone=m.clip_backbone, clip_overrides=clip_overrides, **kw)


def build(config: Config, device="cuda", seed: Optional[int] = None, clip_overrides=(),
          train: bool = False) -> Tuple[Union[ResidualDiffusion, GaussianDiffusion],
                                        Union[FoundDiffDenoiser, UnetRes, VanillaUnet]]:
    """Returns ``(diffusion, model)`` with seeded weights on ``device``.

    ``train=False`` gives the frozen serving model.  ``train=True`` gives the
    model in train mode with the UNets' parameters trainable and the
    Dose-CLIP tower frozen: its forward already runs under ``no_grad``, as the
    JAX model stops its gradient (models/founddiff.py:82-88); without
    ``use_dose_encoder`` there is no tower.  With
    ``original_ddim_ddpm`` the diffusion is the vanilla process at the
    settings of ``founddiff_tpu/factory.py:88-98``: cosine betas,
    ``pred_noise``, l1 loss and DDIM over ``min(250, timesteps)`` steps.
    The device defaults to the card; asking for CUDA on a host without one
    raises rather than running on the CPU.
    """
    device = resolve(device, "build")
    m, d = config.model, config.diffusion
    model = build_denoiser(config, clip_overrides)
    gen = torch.Generator().manual_seed(config.train.seed if seed is None else seed)
    init_params(model, gen)
    model = model.train(train).requires_grad_(train).to(device)

    def model_fn(x_in, time, x_self_cond=None):
        return model(x_in, time, x_self_cond=x_self_cond)

    if m.original_ddim_ddpm:
        return GaussianDiffusion(
            model_fn, image_size=d.image_size, channels=m.channels, timesteps=d.timesteps,
            sampling_timesteps=min(250, d.timesteps), loss_type="l1", objective="pred_noise",
            beta_schedule="cosine", device=device), model
    if m.use_dose_encoder:
        model.dose_encoder.eval().requires_grad_(False)
    diffusion = ResidualDiffusion(
        model_fn, image_size=d.image_size, channels=m.channels, timesteps=d.timesteps,
        sampling_timesteps=d.sampling_timesteps, loss_type=d.loss_type, objective=m.objective,
        condition=m.condition, sum_scale=d.sum_scale, input_condition=m.input_condition,
        input_condition_mask=m.input_condition_mask, test_res_or_noise=m.test_res_or_noise, self_condition=m.self_condition,
        ddim_sampling_eta=d.ddim_sampling_eta, ddim_update=d.ddim_update,
        convert_to_ddim=d.convert_to_ddim, clip_denoised=d.clip_denoised, device=device)
    return diffusion, model
