"""Residual diffusion (RDDM-style) process in PyTorch.

Mirror of ``founddiff_tpu/diffusion/residual.py`` (reference
src/DADiff.py:908-1498): ``model_predictions`` with all four objectives,
``ddim_sample`` with both update rules, and the training loss
(``q_sample``, ``p_losses``, ``loss``).  The JAX ``lax.scan`` over static
time pairs is a Python loop here; ``jax.random`` keys become explicit
``torch.Generator``s, and ``t`` and the noise can be handed in instead.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from founddiff_tpu_torch.diffusion.schedules import (
    ResidualSchedule,
    ddim_time_pairs,
    extract,
    make_residual_schedule,
)
from founddiff_tpu_torch.utils.device import resolve

ModelFn = Callable[..., Sequence[torch.Tensor]]


class ModelResPrediction(NamedTuple):
    pred_res: torch.Tensor
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def normalize_to_neg_one_to_one(x):
    return x * 2.0 - 1.0


def unnormalize_to_zero_to_one(x):
    return (x + 1.0) * 0.5


class ResidualDiffusion:
    """``model_fn(x_in, time_pair, x_self_cond)`` returns one prediction per
    UNet; ``time_pair`` is ``[acs[t]*T, bcs[t]*T]`` (src/DADiff.py:1153-1209).
    ``device``: where ``ddim_sample`` draws when ``x_input`` names none (an
    unconditional sample), the card unless the caller names another (CUDA
    on a host without a card raises)."""

    def __init__(
        self,
        model_fn: ModelFn,
        *,
        image_size: int,
        channels: int = 1,
        timesteps: int = 1000,
        sampling_timesteps: Optional[int] = None,
        loss_type: str = "l1",
        objective: str = "pred_res_noise",
        ddim_sampling_eta: float = 0.0,
        condition: bool = False,
        sum_scale: Optional[float] = None,
        input_condition: bool = False,
        test_res_or_noise: str = "None",
        self_condition: bool = False,
        clip_denoised: bool = True,
        ddim_update: str = "use_pred_noise",
        convert_to_ddim: bool = True,
        aux_grad_loss_weight: float = 0.0,
        aux_wavelet_loss_weight: float = 0.0,
        device="cuda",
    ):
        if ddim_update not in ("use_pred_noise", "use_x_start"):
            raise ValueError(f"unknown ddim_update {ddim_update!r}")
        self.model_fn = model_fn
        self.image_size = image_size
        self.channels = channels
        self.objective = objective
        self.condition = condition
        self.input_condition = input_condition
        self.test_res_or_noise = test_res_or_noise
        self.self_condition = self_condition
        self.clip_denoised = clip_denoised
        self.ddim_update = ddim_update
        self.loss_type = loss_type
        if aux_grad_loss_weight > 0.0 or aux_wavelet_loss_weight > 0.0:
            raise NotImplementedError("the auxiliary Sobel and wavelet losses "
                                      "(founddiff_tpu/ops/losses.py) are not ported")
        self.device = resolve(device, "ResidualDiffusion")
        if condition:
            self.sum_scale = sum_scale if sum_scale is not None else 0.01
            ddim_sampling_eta = 0.0
        else:
            self.sum_scale = sum_scale if sum_scale is not None else 1.0
        self.num_timesteps = timesteps
        self.sampling_timesteps = (
            sampling_timesteps if sampling_timesteps is not None else timesteps
        )
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps exceeds timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        common = dict(convert_to_ddim=convert_to_ddim, sum_scale=self.sum_scale)
        self.train_schedule = make_residual_schedule(timesteps, test=False, **common)
        self.test_schedule = make_residual_schedule(timesteps, test=True, **common)

    # closed-form predictions (src/DADiff.py:1121-1151)

    def q_sample(self, sch, x_start, x_res, t, noise):
        nd = x_start.ndim
        return (x_start + extract(sch.alphas_cumsum, t, nd) * x_res
                + extract(sch.betas_cumsum, t, nd) * noise)

    def predict_noise_from_res(self, sch, x_t, t, x_input, pred_res):
        nd = x_t.ndim
        return (x_t - x_input - (extract(sch.alphas_cumsum, t, nd) - 1.0) * pred_res
                ) / extract(sch.betas_cumsum, t, nd)

    def predict_start_from_xinput_noise(self, sch, x_t, t, x_input, noise):
        nd = x_t.ndim
        return (x_t - extract(sch.alphas_cumsum, t, nd) * x_input
                - extract(sch.betas_cumsum, t, nd) * noise
                ) / extract(sch.one_minus_alphas_cumsum, t, nd)

    def predict_start_from_res_noise(self, sch, x_t, t, x_res, noise):
        nd = x_t.ndim
        return (x_t - extract(sch.alphas_cumsum, t, nd) * x_res
                - extract(sch.betas_cumsum, t, nd) * noise)

    def _model_input(self, x, x_input, x_input_condition):
        if not self.condition:
            return x
        if self.input_condition:
            return torch.cat((x, x_input, x_input_condition), dim=-1)
        return torch.cat((x, x_input), dim=-1)

    def model_predictions(self, sch: ResidualSchedule, x_input, x, t,
                          x_input_condition=None, x_self_cond=None,
                          clip_denoised: Optional[bool] = None) -> ModelResPrediction:
        clip_denoised = self.clip_denoised if clip_denoised is None else clip_denoised
        x_in = self._model_input(x, x_input, x_input_condition)
        time_pair = [sch.alphas_cumsum[t] * self.num_timesteps,
                     sch.betas_cumsum[t] * self.num_timesteps]
        out = self.model_fn(x_in, time_pair, x_self_cond)
        clip = (lambda v: v.clamp(-1.0, 1.0)) if clip_denoised else (lambda v: v)

        if self.objective == "pred_res_noise":
            if self.test_res_or_noise == "res_noise":
                pred_res = clip(out[0])
                pred_noise = out[1]
                x_start = clip(self.predict_start_from_res_noise(sch, x, t, pred_res, pred_noise))
            elif self.test_res_or_noise == "res":
                pred_res = clip(out[0])
                pred_noise = self.predict_noise_from_res(sch, x, t, x_input, pred_res)
                x_start = clip(x_input - pred_res)
            elif self.test_res_or_noise == "noise":
                pred_noise = out[1]
                x_start = clip(self.predict_start_from_xinput_noise(sch, x, t, x_input, pred_noise))
                pred_res = clip(x_input - x_start)
            else:
                raise ValueError(f"unknown test_res_or_noise {self.test_res_or_noise!r}")
        elif self.objective == "pred_x0_noise":
            pred_res = clip(x_input - out[0])
            pred_noise = out[1]
            x_start = clip(out[0])
        elif self.objective == "pred_noise":
            pred_noise = out[0]
            x_start = clip(self.predict_start_from_xinput_noise(sch, x, t, x_input, pred_noise))
            pred_res = clip(x_input - x_start)
        elif self.objective == "pred_res":
            pred_res = clip(out[0])
            pred_noise = self.predict_noise_from_res(sch, x, t, x_input, pred_res)
            x_start = clip(x_input - pred_res)
        else:
            raise ValueError(f"unknown objective {self.objective!r}")
        return ModelResPrediction(pred_res, pred_noise, x_start)

    @torch.no_grad()
    def ddim_sample(self, x_input, shape, *, sch: Optional[ResidualSchedule] = None,
                    last: bool = True, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
        """DDIM sampling (src/DADiff.py:1275-1365).

        The initial noise is ``noise`` when given (tests hand in the JAX
        package's draw), else a standard normal from ``generator`` drawn on
        the CPU, so a seed gives the same image on every device.  The sample
        lies on ``x_input``'s device, or on ``self.device`` when ``x_input``
        is no tensor.
        """
        sch = self.train_schedule if sch is None else sch
        x_input, x_input_condition = self._split_input(x_input)
        ref = x_input if torch.is_tensor(x_input) else None
        device = ref.device if ref is not None else self.device
        sch = sch.to(device)
        eta = self.ddim_sampling_eta
        if noise is None:
            noise = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
        noise = noise.to(device=device, dtype=torch.float32)
        if self.condition:
            img = x_input + math.sqrt(self.sum_scale) * noise
            input_add_noise = img
        else:
            img = noise
            input_add_noise = None

        t_cur, t_next = ddim_time_pairs(self.num_timesteps, self.sampling_timesteps)
        imgs = []
        x_start_prev = torch.zeros(shape, device=device) if self.self_condition else None
        for time, time_next in zip(t_cur, t_next):
            bt = torch.full((shape[0],), time, dtype=torch.long, device=device)
            preds = self.model_predictions(sch, x_input, img, bt, x_input_condition,
                                           x_start_prev)
            pred_res, x_start = preds.pred_res, preds.pred_x_start
            if time_next < 0:
                img = x_start  # final step returns x_start (src/DADiff.py:1320-1324)
            else:
                alpha_cumsum = sch.alphas_cumsum[time]
                alpha_cumsum_next = sch.alphas_cumsum[time_next]
                alpha = alpha_cumsum - alpha_cumsum_next
                b2 = sch.betas2_cumsum[time]
                b2_next = sch.betas2_cumsum[time_next]
                sigma2 = eta * ((b2 - b2_next) * b2_next / b2)
                noise_term = 0.0
                if eta != 0.0:
                    noise_term = torch.sqrt(sigma2) * torch.randn(
                        tuple(shape), generator=generator).to(device)
                if self.ddim_update == "use_x_start":
                    coef = torch.sqrt(b2_next - sigma2) / sch.betas_cumsum[time]
                    img = (coef * img + (1.0 - coef) * x_start
                           + (alpha_cumsum_next - alpha_cumsum * coef) * pred_res
                           + noise_term)
                else:
                    img = img - alpha * pred_res + noise_term
            if self.self_condition:
                x_start_prev = x_start
            if not last:
                imgs.append(img)
        return self._package_samples(img, imgs, input_add_noise, last)

    def _split_input(self, x_input):
        if self.input_condition:
            return x_input[0], x_input[1]
        if isinstance(x_input, (list, tuple)):
            return x_input[0], None
        if x_input is None:
            return 0.0, None
        return x_input, None

    def _package_samples(self, img, imgs, input_add_noise, last):
        if self.condition:
            out = [input_add_noise, img] if last else [input_add_noise] + imgs
        else:
            out = [img] if last else imgs
        return [unnormalize_to_zero_to_one(o) for o in out]

    # training loss (src/DADiff.py:1382-1498)

    def _loss(self, pred, target):
        if self.loss_type == "l1":
            err = (pred - target).abs()
        elif self.loss_type == "l2":
            err = (pred - target).square()
        else:
            raise ValueError(f"invalid loss type {self.loss_type!r}")
        return err.mean()

    def p_losses(self, imgs, t, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 self_cond_flag: Optional[bool] = None):
        """Per-UNet losses at timesteps ``t`` [B] for ``imgs`` in [-1, 1]
        (``[gt, input(, input_condition)]`` or one image).  ``noise`` and the
        self-conditioning coin ``self_cond_flag`` are drawn from
        ``generator`` on the CPU when not given."""
        if isinstance(imgs, (list, tuple)):
            x_input_condition = imgs[2] if self.input_condition else None
            x_input, x_start = imgs[1], imgs[0]
        else:
            x_input, x_start, x_input_condition = 0.0, imgs, None
        device = x_start.device
        sch = self.train_schedule.to(device)
        if noise is None:
            noise = torch.randn(tuple(x_start.shape), generator=generator)
        noise = noise.to(device=device, dtype=x_start.dtype)
        x_res = x_input - x_start
        x = self.q_sample(sch, x_start, x_res, t, noise)
        x_self_cond = None
        if self.self_condition:
            # half of the time, condition on a detached x_start estimate
            # (src/DADiff.py:1423-1432)
            with torch.no_grad():
                pred = self.model_predictions(sch, x_input, x, t, x_input_condition).pred_x_start
            if self_cond_flag is None:
                self_cond_flag = bool(torch.rand((), generator=generator) < 0.5)
            x_self_cond = pred if self_cond_flag else torch.zeros_like(pred)
        x_in = self._model_input(x, x_input, x_input_condition)
        time_pair = [sch.alphas_cumsum[t] * self.num_timesteps,
                     sch.betas_cumsum[t] * self.num_timesteps]
        model_out = self.model_fn(x_in, time_pair, x_self_cond)
        target = {"pred_res_noise": [x_res, noise], "pred_x0_noise": [x_start, noise],
                  "pred_noise": [noise], "pred_res": [x_res]}.get(self.objective)
        if target is None:
            raise ValueError(f"unknown objective {self.objective!r}")
        return [self._loss(model_out[i], target[i]) for i in range(len(model_out))]

    def loss(self, imgs, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """Per-UNet loss list for ``imgs`` in [0, 1] (src/DADiff.py:1484-1498):
        ``t`` is drawn uniformly from ``generator`` when not given."""
        first = imgs[0] if isinstance(imgs, (list, tuple)) else imgs
        if t is None:
            t = torch.randint(0, self.num_timesteps, (first.shape[0],), generator=generator)
        t = t.to(first.device)
        if isinstance(imgs, (list, tuple)):
            imgs = [normalize_to_neg_one_to_one(x) for x in imgs]
        else:
            imgs = normalize_to_neg_one_to_one(imgs)
        return self.p_losses(imgs, t, noise, generator)
