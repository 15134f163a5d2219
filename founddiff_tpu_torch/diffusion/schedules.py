"""Residual-diffusion and gaussian (DDPM) schedules (mirror of
``founddiff_tpu/diffusion/schedules.py``).

The coefficients are computed in numpy float32 exactly as the JAX package
does, then held as float32 tensors.  The *train* schedule zeroes the t=0
increments (reference src/DADiff.py:974-977); the *test* schedule of
``ResidualDiffusion.init()`` copies them from t=1 (src/DADiff.py:1064-1067).
Both apply the posterior t=0 overrides and ``one_minus_alphas_cumsum[-1] =
1e-6`` (src/DADiff.py:1024-1027).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


def gen_coefficients(timesteps: int, schedule: str = "increased",
                     sum_scale: float = 1.0, ratio: float = 1.0) -> np.ndarray:
    """Per-step increments summing to ``sum_scale`` (src/DADiff.py:846-874)."""
    if schedule == "increased":
        y = np.linspace(0, 1, timesteps, dtype=np.float32) ** ratio
        alphas = y / y.sum()
    elif schedule == "decreased":
        y = (np.linspace(0, 1, timesteps, dtype=np.float32) ** ratio)[::-1].copy()
        alphas = y / y.sum()
    else:  # "average"
        alphas = np.full([timesteps], 1.0 / timesteps, dtype=np.float32)
    return (alphas * sum_scale).astype(np.float32)


def betas_for_alpha_bar(num_diffusion_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Glide / squaredcos_cap_v2 cosine beta schedule (src/DADiff.py:878-906)."""

    def alpha_bar(time_step: float) -> float:
        return math.cos((time_step + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [min(1 - alpha_bar((i + 1) / num_diffusion_timesteps)
                 / alpha_bar(i / num_diffusion_timesteps), max_beta)
             for i in range(num_diffusion_timesteps)]
    return np.asarray(betas, dtype=np.float32)


def make_beta_schedule(timesteps: int, beta_schedule: str = "linear",
                       beta_start: float = 0.0001, beta_end: float = 0.02) -> np.ndarray:
    """Base beta schedule of the DDIM-converted residual schedule
    (src/DADiff.py:952-970): ``linear``, ``scaled_linear`` or
    ``squaredcos_cap_v2``; another name raises ``NotImplementedError``."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, timesteps, dtype=np.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        return betas_for_alpha_bar(timesteps)
    raise NotImplementedError(f"unknown beta schedule {beta_schedule!r}")


@dataclasses.dataclass(frozen=True)
class ResidualSchedule:
    """float32 ``[timesteps]`` coefficient tensors (src/DADiff.py:1008-1027)."""

    alphas: torch.Tensor
    alphas_cumsum: torch.Tensor
    one_minus_alphas_cumsum: torch.Tensor
    betas2: torch.Tensor
    betas: torch.Tensor
    betas2_cumsum: torch.Tensor
    betas_cumsum: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_mean_coef3: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    num_timesteps: int

    def to(self, device) -> "ResidualSchedule":
        return ResidualSchedule(**{
            f.name: (getattr(self, f.name).to(device)
                     if f.name != "num_timesteps" else self.num_timesteps)
            for f in dataclasses.fields(self)
        })


def _pad_prev(x: np.ndarray, value: float) -> np.ndarray:
    return np.concatenate([np.asarray([value], dtype=x.dtype), x[:-1]])


def make_residual_schedule(timesteps: int = 1000, *, test: bool = False,
                           convert_to_ddim: bool = True, beta_schedule: str = "linear",
                           beta_start: float = 0.0001, beta_end: float = 0.02,
                           sum_scale: float = 1.0) -> ResidualSchedule:
    """``test=False``: the reference ctor (src/DADiff.py:946-1027);
    ``test=True``: ``ResidualDiffusion.init()`` (src/DADiff.py:1033-1118).
    ``beta_schedule``, ``beta_start`` and ``beta_end`` go to
    :func:`make_beta_schedule` on the DDIM-converted route."""
    if convert_to_ddim:
        betas = make_beta_schedule(timesteps, beta_schedule, beta_start, beta_end)
        alphas_cumprod = np.cumprod((1.0 - betas).astype(np.float32))
        alphas_cumsum = 1.0 - alphas_cumprod**0.5
        betas2_cumsum = 1.0 - alphas_cumprod
        alphas_cumsum_prev = _pad_prev(alphas_cumsum, 1.0)
        betas2_cumsum_prev = _pad_prev(betas2_cumsum, 1.0)
        alphas = alphas_cumsum - alphas_cumsum_prev
        betas2 = betas2_cumsum - betas2_cumsum_prev
        alphas[0] = alphas[1] if test else 0.0
        betas2[0] = betas2[1] if test else 0.0
    else:
        if test:
            alphas = gen_coefficients(timesteps, schedule="average", ratio=1)
            betas2 = gen_coefficients(timesteps, schedule="increased",
                                      sum_scale=sum_scale, ratio=3)
        else:
            alphas = gen_coefficients(timesteps, schedule="decreased")
            betas2 = gen_coefficients(timesteps, schedule="increased",
                                      sum_scale=sum_scale)
        alphas_cumsum = np.clip(np.cumsum(alphas), 0, 1)
        betas2_cumsum = np.clip(np.cumsum(betas2), 0, 1)
        pad_a = float(alphas_cumsum[1]) if test else 1.0
        pad_b = float(betas2_cumsum[1]) if test else 1.0
        alphas_cumsum_prev = _pad_prev(alphas_cumsum, pad_a)
        betas2_cumsum_prev = _pad_prev(betas2_cumsum, pad_b)

    with np.errstate(divide="ignore", invalid="ignore"):
        posterior_variance = betas2 * betas2_cumsum_prev / betas2_cumsum
        posterior_variance[0] = 0.0
        coef1 = betas2_cumsum_prev / betas2_cumsum
        coef2 = (betas2 * alphas_cumsum_prev - betas2_cumsum_prev * alphas) / betas2_cumsum
        coef3 = betas2 / betas2_cumsum
    log_var = np.log(np.clip(posterior_variance, 1e-20, None))
    one_minus_alphas_cumsum = 1.0 - alphas_cumsum
    coef1[0] = 0.0
    coef2[0] = 0.0
    coef3[0] = 1.0
    one_minus_alphas_cumsum[-1] = 1e-6

    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    return ResidualSchedule(
        alphas=f32(alphas),
        alphas_cumsum=f32(alphas_cumsum),
        one_minus_alphas_cumsum=f32(one_minus_alphas_cumsum),
        betas2=f32(betas2),
        betas=f32(np.sqrt(betas2)),
        betas2_cumsum=f32(betas2_cumsum),
        betas_cumsum=f32(np.sqrt(betas2_cumsum)),
        posterior_mean_coef1=f32(coef1),
        posterior_mean_coef2=f32(coef2),
        posterior_mean_coef3=f32(coef3),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(log_var),
        num_timesteps=int(timesteps),
    )


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """lucidrains linear schedule scaled for the 1000-step regime
    (src/denoising_diffusion_pytorch.py:419-424), float32."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64).astype(np.float32)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule (src/denoising_diffusion_pytorch.py:427-435),
    float32."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class GaussianSchedule:
    """float32 ``[timesteps]`` coefficient tensors of the DDPM process
    (``GaussianSchedule``, founddiff_tpu/diffusion/schedules.py:265-283)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor
    num_timesteps: int

    def to(self, device) -> "GaussianSchedule":
        return GaussianSchedule(**{
            f.name: (getattr(self, f.name).to(device)
                     if f.name != "num_timesteps" else self.num_timesteps)
            for f in dataclasses.fields(self)
        })


def make_gaussian_schedule(timesteps: int = 1000, *, beta_schedule: str = "linear",
                           p2_loss_weight_gamma: float = 0.0,
                           p2_loss_weight_k: float = 1.0) -> GaussianSchedule:
    """The betas in float32, every coefficient from them in float64, each
    stored as a float32 tensor."""
    if beta_schedule == "linear":
        betas = linear_beta_schedule(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule!r}")
    betas = betas.astype(np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    return GaussianSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        p2_loss_weight=f32((p2_loss_weight_k + acp / (1 - acp)) ** -p2_loss_weight_gamma),
        num_timesteps=int(timesteps),
    )


def ddim_time_pairs(num_timesteps: int, sampling_timesteps: int) -> Tuple[list, list]:
    """Static DDIM pairs ``[(T-1, ...), ..., (t1, -1)]`` (src/DADiff.py:1288-1292)."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return times[:-1], times[1:]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``a[t]`` reshaped to ``[B, 1, ..., 1]`` (src/DADiff.py:840-843)."""
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def same_shape(img, shape) -> None:
    """The JAX samplers carry the image through ``lax.scan``, which refuses
    a step whose image changes shape (a ``learned_variance`` UNet's two
    channels a pixel): the same ``TypeError`` here."""
    if tuple(img.shape) != tuple(shape):
        raise TypeError(f"the sampler's image changes shape in a step: {tuple(shape)} -> "
                        f"{tuple(img.shape)} (a prediction of another shape, as "
                        "learned_variance gives, cannot be sampled)")
