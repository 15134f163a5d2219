"""Trainer: the train step, the training loop, checkpoints and sampling
(mirror of ``founddiff_tpu/train/trainer.py``; reference
src/DADiff.py:1506-1971).

One step (``Trainer._step_fn``, trainer.py:132-214): the batch splits into
``gradient_accumulate_every`` microbatches; each adds the gradient of its
``sum(losses) / accum``; then optax's global-norm clip, Adam (RAdam for two
UNets), the EMA update, step += 1.  ``mixed_precision="bf16"`` runs the
model on bf16 copies of every fp32 tensor the JAX step casts (trainer.py:
141-184): every parameter, the frozen Dose-CLIP tower's too, and the
buffers the JAX tree holds as parameters (BatchNorm statistics, prompt
token embeddings); gradients reach the fp32 masters through the cast.  The
inputs are cast to bf16 and the predictions back to fp32 for the loss.
The conditional (FoundDiff) and the generation (vanilla DDPM) paths both
train here; ``sample()`` follows the JAX ``Trainer.sample`` routes.

Random draws (timesteps, noise) come from one ``torch.Generator`` seeded
with ``train.seed``, on the CPU, so a seed gives the same run on every
device.  ``test()`` with its per-anatomy metrics and FID waits for the
data modules.
"""

from __future__ import annotations

import copy
import glob
import itertools
import logging
import os
import re
import time
from typing import Iterable, List, Optional

import torch

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.pipeline import make_hoisted_sampler
from founddiff_tpu_torch.train.ema import ema_update
from founddiff_tpu_torch.train.state import clip_by_global_norm_, make_optimizer


def _logger(path: str) -> logging.Logger:
    log = logging.getLogger(f"founddiff_tpu_torch.train:{path}")
    if not log.handlers:
        log.setLevel(logging.INFO)
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        log.addHandler(handler)
    return log


class Trainer:
    """Trains ``model`` (from ``factory.build(..., train=True)``) under
    ``diffusion``'s loss with ``config.train``."""

    def __init__(self, diffusion, model, config: Config):
        tcfg = config.train
        self.diffusion, self.model, self.config = diffusion, model, config
        self.num_unet = config.model.num_unet
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt = make_optimizer(self.params, self.num_unet, tcfg.train_lr, tcfg.adam_betas)
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.ema_step = 0
        self.step = 0
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        self.checkpoint_folder = tcfg.checkpoint_folder
        self.results_folder = os.path.join(self.checkpoint_folder, "sample")
        self._diffusion = copy.copy(diffusion)
        self._diffusion.model_fn = self._model_fn

    def _model_fn(self, x_in, time, x_self_cond=None):
        if self.config.train.mixed_precision != "bf16":
            return self.model(x_in, time, x_self_cond=x_self_cond)
        bf16 = torch.bfloat16
        named = itertools.chain(self.model.named_parameters(), self.model.named_buffers())
        tensors = {n: t.to(bf16) for n, t in named if t.dtype == torch.float32}
        out = torch.func.functional_call(
            self.model, tensors, (x_in.to(bf16), time),
            {"x_self_cond": None if x_self_cond is None else x_self_cond.to(bf16)})
        if torch.is_tensor(out):  # the vanilla UNet's one prediction
            return out.float()
        return [o.float() if torch.is_tensor(o) else o for o in out]

    def train_step(self, batch) -> List[float]:
        """One optimisation step on ``batch = (gt, ld)``, NHWC in [0, 1] with
        ``train_batch_size * gradient_accumulate_every`` slices; returns the
        per-UNet losses averaged over the microbatches."""
        tcfg = self.config.train
        accum = tcfg.gradient_accumulate_every
        gt, ld = batch
        device = self.params[0].device
        gt, ld = gt.to(device), ld.to(device)
        micro = gt.shape[0] // accum
        for p in self.params:
            p.grad = None
        losses = torch.zeros(self.num_unet, device=device)
        for i in range(accum):
            part = slice(i * micro, (i + 1) * micro)
            if self.diffusion.condition:
                out = self._diffusion.loss([gt[part], ld[part]], generator=self.generator)
            else:  # generation: the single image stream (src/DADiff.py:1691-1694)
                out = [self._diffusion.loss(gt[part], generator=self.generator)]
            (sum(out) / accum).backward()
            losses += torch.stack([torch.as_tensor(l, device=device).detach().float()
                                   for l in out]) / accum
        clip_by_global_norm_(self.params, tcfg.max_grad_norm)
        self.opt.step()
        self.ema_step = ema_update(list(self.ema.parameters()), list(self.model.parameters()),
                                   self.ema_step, beta=tcfg.ema_decay,
                                   update_every=tcfg.ema_update_every)
        self.step += 1
        return losses.tolist()

    def train(self, batches: Iterable, log_every: int = 50) -> None:
        """The training loop (src/DADiff.py:1673-1763) over ``(gt, ld)``
        batches until ``train_num_steps``; logs to ``train.log`` in the
        checkpoint folder and saves at the JAX trainer's cadence."""
        tcfg = self.config.train
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        log = _logger(os.path.join(self.checkpoint_folder, "train.log"))
        t0 = time.time()
        for batch in batches:
            if self.step >= tcfg.train_num_steps:
                break
            losses = self.train_step(batch)
            step = self.step
            if step % log_every == 0 or step == 1:
                rate = log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                log.info(f"step {step}/{tcfg.train_num_steps} "
                         + " ".join(f"loss_unet{i}: {v:.6f}" for i, v in enumerate(losses))
                         + f" ({rate:.2f} it/s)")
            every = tcfg.save_and_sample_every
            if step > every * 10 * 4 and step % (every * 10) == 0:
                self.save(step // every)
        log.info("training complete")

    def _ckpt_path(self, milestone) -> str:
        return os.path.join(self.results_folder, f"model-{milestone}.pt")

    def save(self, milestone) -> str:
        """``model-<milestone>.pt`` in the reference layout
        (src/DADiff.py:1626-1646): ``model`` is the diffusion state dict
        (``model.<port name>``), ``ema`` the ema_pytorch state dict
        (``ema_model.model.<port name>``)."""
        os.makedirs(self.results_folder, exist_ok=True)
        data = {
            "step": self.step,
            "model": {f"model.{k}": v for k, v in self.model.state_dict().items()},
            "opt": self.opt.state_dict(),
            "ema": {"initted": torch.tensor(True), "step": torch.tensor(self.ema_step),
                    **{f"ema_model.model.{k}": v for k, v in self.ema.state_dict().items()}},
        }
        path = self._ckpt_path(milestone)
        torch.save(data, path)
        self._prune_checkpoints()
        return path

    def _prune_checkpoints(self) -> None:
        keep = self.config.train.keep_checkpoints
        if keep <= 0:
            return
        found = []
        for p in glob.glob(os.path.join(self.results_folder, "model-*.pt")):
            m = re.fullmatch(r"model-(\d+)\.pt", os.path.basename(p))
            if m:
                found.append((int(m.group(1)), p))
        for _, p in sorted(found)[:-keep]:
            os.remove(p)

    def load(self, milestone) -> None:
        device = self.params[0].device
        data = torch.load(self._ckpt_path(milestone), map_location=device, weights_only=True)
        strip = lambda sd, pre: {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        self.model.load_state_dict(strip(data["model"], "model."))
        self.ema.load_state_dict(strip(data["ema"], "ema_model.model."))
        self.opt.load_state_dict(data["opt"])
        self.step = int(data["step"])
        self.ema_step = int(data["ema"]["step"])

    def sample(self, x_input01=None, generator: Optional[torch.Generator] = None,
               noise=None, compute_dtype=None):
        """Samples with the EMA weights, as the JAX ``Trainer.sample``
        (trainer.py:341-389) routes them.  Conditional: hoisted-tower DDIM of
        the conditioning slices ``x_input01`` on the training schedule
        (``noise``: the initial noise).  Generation (vanilla DDPM):
        ``diffusion.sample(batch_size=num_samples)``, ``x_input01`` unused
        (``noise``: every draw, as ``GaussianDiffusion.sample`` takes them)."""
        if not self.diffusion.condition:
            d = copy.copy(self.diffusion)
            d.model_fn = lambda x, t, x_self_cond=None: self.ema(x, t, x_self_cond=x_self_cond)
            return d.sample(batch_size=self.config.train.num_samples, generator=generator,
                            noise=noise)
        sampler = make_hoisted_sampler(self.ema, self.diffusion, use_test_schedule=False,
                                       compute_dtype=compute_dtype)
        return sampler(x_input01, generator=generator, noise=noise)
