"""Build the serving path from a Config (mirror of ``founddiff_tpu/factory.py``
restricted to the FoundDiff path: CLIPIQA tower + UnetRes + ResidualDiffusion).

Weights are drawn on the CPU from an explicit ``torch.Generator`` with the
reference's init distributions (torch-default uniform for Linear/Conv, S4D
for the scan, zero adaLN), then moved to ``device``, so one seed gives the
same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion
from founddiff_tpu_torch.models.blocks import TransposedAttention
from founddiff_tpu_torch.models.clip import CLIP, AttentionPool2d, PromptLearner, _MHAWeights
from founddiff_tpu_torch.models.founddiff import FoundDiffDenoiser
from founddiff_tpu_torch.models.ss2d import SS2D, MambaBlock
from founddiff_tpu_torch.models.unet import Unet


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


def build_denoiser(config: Config, clip_overrides=()) -> FoundDiffDenoiser:
    m = config.model
    return FoundDiffDenoiser(
        dim=m.dim, dim_mults=tuple(m.dim_mults), channels=m.channels,
        num_unet=m.num_unet, condition=m.condition, input_condition=m.input_condition,
        self_condition=m.self_condition, resnet_block_groups=m.resnet_block_groups,
        objective=m.objective, test_res_or_noise=m.test_res_or_noise,
        base_d_state=m.base_d_state, ssm_expand=m.ssm_expand,
        clip_backbone=m.clip_backbone, clip_overrides=clip_overrides)


def build(config: Config, device="cuda", seed: Optional[int] = None,
          clip_overrides=()) -> Tuple[ResidualDiffusion, FoundDiffDenoiser]:
    """Returns ``(diffusion, model)`` with seeded weights on ``device``.

    The device defaults to the card; asking for CUDA on a host without one
    raises rather than running on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build: CUDA device requested but no GPU is available; "
                           "pass device='cpu' to run the plain versions")
    m, d = config.model, config.diffusion
    model = build_denoiser(config, clip_overrides)
    gen = torch.Generator().manual_seed(config.train.seed if seed is None else seed)
    init_params(model, gen)
    model = model.eval().requires_grad_(False).to(device)

    def model_fn(x_in, time, x_self_cond=None):
        return model(x_in, time, x_self_cond=x_self_cond)

    diffusion = ResidualDiffusion(
        model_fn, image_size=d.image_size, channels=m.channels, timesteps=d.timesteps,
        sampling_timesteps=d.sampling_timesteps, objective=m.objective,
        condition=m.condition, sum_scale=d.sum_scale, input_condition=m.input_condition,
        test_res_or_noise=m.test_res_or_noise, self_condition=m.self_condition,
        ddim_sampling_eta=d.ddim_sampling_eta, ddim_update=d.ddim_update,
        convert_to_ddim=d.convert_to_ddim, clip_denoised=d.clip_denoised)
    return diffusion, model
