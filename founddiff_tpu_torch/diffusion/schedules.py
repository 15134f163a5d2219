"""Residual-diffusion schedules (mirror of ``founddiff_tpu/diffusion/schedules.py``).

The coefficients are computed in numpy float32 exactly as the JAX package
does, then held as float32 tensors.  The *train* schedule zeroes the t=0
increments (reference src/DADiff.py:974-977); the *test* schedule of
``ResidualDiffusion.init()`` copies them from t=1 (src/DADiff.py:1064-1067).
Both apply the posterior t=0 overrides and ``one_minus_alphas_cumsum[-1] =
1e-6`` (src/DADiff.py:1024-1027).
"""

from __future__ import annotations

import dataclasses
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


def make_beta_schedule(timesteps: int, beta_start: float = 0.0001,
                       beta_end: float = 0.02) -> np.ndarray:
    """Linear base beta schedule (src/DADiff.py:952-970)."""
    return np.linspace(beta_start, beta_end, timesteps, dtype=np.float32)


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
                           convert_to_ddim: bool = True,
                           sum_scale: float = 1.0) -> ResidualSchedule:
    """``test=False``: the reference ctor (src/DADiff.py:946-1027);
    ``test=True``: ``ResidualDiffusion.init()`` (src/DADiff.py:1033-1118)."""
    if convert_to_ddim:
        betas = make_beta_schedule(timesteps)
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


def ddim_time_pairs(num_timesteps: int, sampling_timesteps: int) -> Tuple[list, list]:
    """Static DDIM pairs ``[(T-1, ...), ..., (t1, -1)]`` (src/DADiff.py:1288-1292)."""
    times = np.linspace(-1, num_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(int).tolist()))
    return times[:-1], times[1:]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``a[t]`` reshaped to ``[B, 1, ..., 1]`` (src/DADiff.py:840-843)."""
    out = a[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
