"""Vanilla DDPM/DDIM gaussian diffusion in PyTorch.

Mirror of ``founddiff_tpu/diffusion/gaussian.py`` (the lucidrains stack the
reference bundles as its baseline, src/denoising_diffusion_pytorch.py:437-731,
selected by ``original_ddim_ddpm=True``): objectives ``pred_noise | pred_x0 |
pred_v``, p2 loss weighting, the DDPM ancestral and the DDIM samplers, and
the training loss.  The JAX ``lax.scan`` loops are Python loops here;
``jax.random`` keys become explicit ``torch.Generator``s whose draws are made
on the CPU (so a seed gives the same image on every device), and every draw
can be handed in instead (``t=``, ``noise=``), as the tests hand in the JAX
package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from founddiff_tpu_torch.diffusion.residual import (
    normalize_to_neg_one_to_one,
    unnormalize_to_zero_to_one,
)
from founddiff_tpu_torch.diffusion.schedules import (
    GaussianSchedule,
    extract,
    make_gaussian_schedule,
    same_shape,
)
from founddiff_tpu_torch.utils import trace
from founddiff_tpu_torch.utils.device import resolve

ModelFn = Callable[..., torch.Tensor]


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


class GaussianDiffusion:
    """Functional DDPM process.  ``model_fn(x, t, x_self_cond)`` returns the
    raw UNet output, one tensor.  ``device``: where ``sample`` puts its
    images, the card unless the caller names another (CUDA on a host
    without a card raises)."""

    condition = False  # the trainer's generation branch (no conditioning image)

    def __init__(
        self,
        model_fn: ModelFn,
        *,
        image_size: int,
        channels: int = 3,
        timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        loss_type: str = "l1",
        objective: str = "pred_noise",
        beta_schedule: str = "cosine",
        p2_loss_weight_gamma: float = 0.0,
        p2_loss_weight_k: float = 1.0,
        ddim_sampling_eta: float = 1.0,
        self_condition: bool = False,
        clip_denoised: bool = True,
        device="cuda",
    ):
        if objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {objective!r}")
        self.model_fn = model_fn
        self.image_size = image_size
        self.channels = channels
        self.objective = objective
        self.loss_type = loss_type
        self.self_condition = self_condition
        self.clip_denoised = clip_denoised
        self.device = resolve(device, "GaussianDiffusion")
        self._on_device = {}
        self.schedule = make_gaussian_schedule(
            timesteps, beta_schedule=beta_schedule, p2_loss_weight_gamma=p2_loss_weight_gamma,
            p2_loss_weight_k=p2_loss_weight_k)
        self.num_timesteps = timesteps
        self.sampling_timesteps = (
            sampling_timesteps if sampling_timesteps is not None else timesteps
        )
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.ddim_sampling_eta = ddim_sampling_eta

    def _sch(self, device) -> GaussianSchedule:
        """The schedule on ``device``, copied there once."""
        if device not in self._on_device:
            self._on_device[device] = self.schedule.to(device)
        return self._on_device[device]

    # closed forms (gaussian.py:88-132)

    def predict_start_from_noise(self, x_t, t, noise):
        s, nd = self._sch(x_t.device), x_t.ndim
        return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        s, nd = self._sch(x_t.device), x_t.ndim
        return ((extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_v(self, x_start, t, noise):
        s, nd = self._sch(x_start.device), x_start.ndim
        return (extract(s.sqrt_alphas_cumprod, t, nd) * noise
                - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s, nd = self._sch(x_t.device), x_t.ndim
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_t
                - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        s, nd = self._sch(x_t.device), x_t.ndim
        mean = (extract(s.posterior_mean_coef1, t, nd) * x_start
                + extract(s.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(s.posterior_variance, t, nd),
                extract(s.posterior_log_variance_clipped, t, nd))

    def q_sample(self, x_start, t, noise):
        s, nd = self._sch(x_start.device), x_start.ndim
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    # model wrapper (gaussian.py:136-160)

    def model_predictions(self, x, t, x_self_cond=None,
                          clip_x_start: bool = False) -> ModelPrediction:
        out = self.model_fn(x, t, x_self_cond)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_x_start else (lambda v: v)
        if self.objective == "pred_noise":
            pred_noise = out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif self.objective == "pred_x0":
            x_start = clip(out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:  # pred_v
            x_start = clip(self.predict_start_from_v(x, t, out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return ModelPrediction(pred_noise, x_start)

    def p_mean_variance(self, x, t, x_self_cond=None):
        x_start = self.model_predictions(x, t, x_self_cond).pred_x_start
        if self.clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        mean, var, log_var = self.q_posterior(x_start, x, t)
        return mean, var, log_var, x_start

    # samplers (gaussian.py:164-220)

    def _draws(self, shape, steps: int, generator, noise, device):
        """The initial image and one draw per step: ``noise`` (a sequence of
        ``steps + 1`` tensors) when given, else standard normals from
        ``generator`` on the CPU, drawn as they are used."""
        if noise is not None:
            if len(noise) != steps + 1:
                raise ValueError(f"noise: {len(noise)} draws, want {steps + 1}")
            return (n.to(device=device, dtype=torch.float32) for n in noise)
        return (torch.randn(tuple(shape), generator=generator).to(device)
                for _ in range(steps + 1))

    @torch.no_grad()
    def p_sample_loop(self, shape, generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None):
        """DDPM ancestral sampling over all ``num_timesteps`` steps; the
        last step's draw is made and not used, as in the JAX loop."""
        device = self.device
        draws = self._draws(shape, self.num_timesteps, generator, noise, device)
        img = next(draws)
        for t in range(self.num_timesteps - 1, -1, -1):
            with trace.span("ddim.step", device=True, t=t, t_next=t - 1):
                bt = torch.full((shape[0],), t, dtype=torch.long, device=device)
                mean, _, log_var, _ = self.p_mean_variance(img, bt)
                z = next(draws)
                img = mean + torch.exp(0.5 * log_var) * z if t > 0 else mean
                same_shape(img, shape)
        return unnormalize_to_zero_to_one(img)

    @torch.no_grad()
    def ddim_sample(self, shape, generator: Optional[torch.Generator] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None):
        """DDIM over ``sampling_timesteps`` steps with ``ddim_sampling_eta``:
        ``times = linspace(-1, T-1, S+1)`` truncated and reversed;
        ``alpha_next`` read at ``max(time_next, 0)``; a draw at every step;
        the last step returns ``x_start``."""
        device = self.device
        acp = self._sch(device).alphas_cumprod
        eta = self.ddim_sampling_eta
        times = np.linspace(-1, self.num_timesteps - 1, self.sampling_timesteps + 1)
        times = list(reversed(times.astype(int).tolist()))
        draws = self._draws(shape, self.sampling_timesteps, generator, noise, device)
        img = next(draws)
        for time, time_next in zip(times[:-1], times[1:]):
            with trace.span("ddim.step", device=True, t=time, t_next=time_next):
                bt = torch.full((shape[0],), time, dtype=torch.long, device=device)
                pred_noise, x_start = self.model_predictions(img, bt,
                                                             clip_x_start=self.clip_denoised)
                z = next(draws)
                if time_next < 0:
                    img = x_start
                    same_shape(img, shape)
                    continue
                alpha, alpha_next = acp[time], acp[time_next]
                sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
                c = torch.sqrt(1 - alpha_next - sigma ** 2)
                img = x_start * torch.sqrt(alpha_next) + c * pred_noise + sigma * z
                same_shape(img, shape)
        return unnormalize_to_zero_to_one(img)

    def sample(self, batch_size: int = 16, generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None):
        """``batch_size`` images [B, S, S, channels] in [0, 1] on ``device``:
        DDIM when ``sampling_timesteps < timesteps``, else DDPM."""
        shape = (batch_size, self.image_size, self.image_size, self.channels)
        fn = self.ddim_sample if self.is_ddim_sampling else self.p_sample_loop
        return fn(shape, generator=generator, noise=noise)

    # loss (gaussian.py:224-261)

    def p_losses(self, x_start, t, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 self_cond_flag: Optional[bool] = None):
        """The p2-weighted l1/l2 loss at timesteps ``t`` [B] of ``x_start``
        in [-1, 1].  ``noise`` and the self-conditioning coin are drawn from
        ``generator`` on the CPU when not given."""
        with trace.span("train.draws"):
            if noise is None:
                noise = torch.randn(tuple(x_start.shape), generator=generator)
            noise = noise.to(device=x_start.device, dtype=x_start.dtype)
        x = self.q_sample(x_start, t, noise)
        x_self_cond = None
        if self.self_condition:
            with torch.no_grad():
                pred = self.model_predictions(x, t).pred_x_start
            if self_cond_flag is None:
                self_cond_flag = bool(torch.rand((), generator=generator) < 0.5)
            x_self_cond = pred if self_cond_flag else torch.zeros_like(pred)
        out = self.model_fn(x, t, x_self_cond)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        if self.loss_type == "l1":
            err = (out - target).abs()
        elif self.loss_type == "l2":
            err = (out - target).square()
        else:
            raise ValueError(f"invalid loss type {self.loss_type!r}")
        err = err.reshape(err.shape[0], -1).mean(dim=1)
        return (err * self._sch(err.device).p2_loss_weight[t]).mean()

    def loss(self, img, t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """The loss of images ``img`` in [0, 1]; ``t`` uniform in [0, T) from
        ``generator`` when not given."""
        with trace.span("train.draws"):
            if t is None:
                t = torch.randint(0, self.num_timesteps, (img.shape[0],), generator=generator)
            t = t.to(img.device)
        return self.p_losses(normalize_to_neg_one_to_one(img), t, noise,
                             generator)


__all__ = ["GaussianDiffusion", "ModelPrediction"]
