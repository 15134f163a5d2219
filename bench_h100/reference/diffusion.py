"""Plain reference of the two diffusion processes, their serving sampler and
their training losses, and of the optimiser step both train cells run.

- Residual diffusion (FoundDiff, src/DADiff.py:908-1498) with the DDIM
  schedule conversion (linear betas 1e-4 .. 2e-2 over T steps), objective
  ``pred_res``, l2 loss, sum_scale 0.01 and clipping to [-1, 1]; serving
  is DDIM on the test schedule, eta 0, with the tower run once a slice.
- The vanilla DDPM (lucidrains GaussianDiffusion): cosine betas,
  ``pred_noise``, l1 loss.
- The step: microbatches, the gradient clipped to a global norm (optax's
  rule: scaled only at or over the limit), Adam, and ema_pytorch's EMA
  (a copy while its counter is at most 100, read at every tenth call).

Random draws (t, then the noise, per microbatch) come from one CPU
``torch.Generator`` as the trainer under test draws them, so the reference
re-derives them from the seed.  Imports nothing but numpy, torch and this
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import precision as P


def residual_schedule(T: int, test: bool):
    """(alphas_cumsum, betas_cumsum) float32 tensors of the DDIM-converted
    residual schedule; the train and test schedules differ only at t = 0."""
    betas = np.linspace(1e-4, 0.02, T, dtype=np.float32)
    acp = np.cumprod((1.0 - betas).astype(np.float32))
    alphas_cumsum = 1.0 - acp ** 0.5
    betas_cumsum = np.sqrt(1.0 - acp)
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    return f32(alphas_cumsum), f32(betas_cumsum)


def ddim_pairs(T: int, steps: int):
    times = list(reversed(np.linspace(-1, T - 1, steps + 1).astype(int).tolist()))
    return list(zip(times[:-1], times[1:]))


@torch.no_grad()
def serve(model, x01, noise, steps: int = 2, T: int = 1000, sum_scale: float = 0.01,
          trunk: str = "fp32", tower: str = "fp32"):
    """Denoised slices in [0, 1] of ``x01`` [B, H, W, 1] and the tower's
    ``(dose, content)`` embeddings: the tower once, then ``steps`` DDIM
    steps of the UNet from ``x + sqrt(sum_scale) * noise``; ``trunk`` and
    ``tower`` are the precisions of the UNet's and the tower's products."""
    x = x01.float() * 2 - 1
    with P.products(tower):
        dose, content = model.encode(x)
    acs, _ = (s.to(x.device) for s in residual_schedule(T, test=True))
    img = x + math.sqrt(sum_scale) * noise.float()
    for t, t_next in ddim_pairs(T, steps):
        time = torch.full((x.shape[0],), float(t), device=x.device)
        time = acs[time.long()] * T
        with P.products(trunk):
            out = model(torch.cat([img, x], dim=-1), time, dose, content)
        pred_res = out.clamp(-1, 1)
        x_start = (x - pred_res).clamp(-1, 1)
        img = x_start if t_next < 0 else img - (acs[t] - acs[t_next]) * pred_res
    return (img + 1) / 2, (dose, content)


def residual_loss(model, gt01, ld01, gen, T: int = 1000):
    """FoundDiff's l2 loss on the residual at t ~ U[0, T) and one noise draw."""
    B = gt01.shape[0]
    t = torch.randint(0, T, (B,), generator=gen)
    noise = torch.randn(tuple(gt01.shape), generator=gen).to(gt01.device)
    t = t.to(gt01.device)
    gt, ld = gt01.float() * 2 - 1, ld01.float() * 2 - 1
    acs, bcs = (s.to(gt.device) for s in residual_schedule(T, test=False))
    x_res = ld - gt
    x = gt + acs[t][:, None, None, None] * x_res + bcs[t][:, None, None, None] * noise
    with torch.no_grad():
        dose, content = model.encode(ld)
    out = model(torch.cat([x, ld], dim=-1), acs[t] * T, dose, content)
    return (out - x_res).square().mean()


def cosine_alphas_cumprod(T: int, s: float = 0.008) -> torch.Tensor:
    x = np.linspace(0, T, T + 1, dtype=np.float64)
    acp = np.cos(((x / T) + s) / (1 + s) * math.pi * 0.5) ** 2
    acp = acp / acp[0]
    betas = np.clip(1 - acp[1:] / acp[:-1], 0, 0.999).astype(np.float32).astype(np.float64)
    return torch.as_tensor(np.cumprod(1.0 - betas).astype(np.float32))


def gaussian_loss(model, gt01, ld01, gen, T: int = 1000):
    """The vanilla DDPM's l1 loss on the noise (p2 weight 1)."""
    B = gt01.shape[0]
    t = torch.randint(0, T, (B,), generator=gen)
    noise = torch.randn(tuple(gt01.shape), generator=gen).to(gt01.device)
    t = t.to(gt01.device)
    acp = cosine_alphas_cumprod(T).to(gt01.device)[t][:, None, None, None]
    x = acp.sqrt() * (gt01.float() * 2 - 1) + (1 - acp).sqrt() * noise
    out = model(x, t)
    return (out - noise).abs().reshape(B, -1).mean(dim=1).mean()


LOSSES = {"residual": residual_loss, "gaussian": gaussian_loss}


def train_steps(model, names, batches, seed: int, loss: str, accum: int, lr: float,
                betas, max_norm: float, eps: float = 1e-8, products: str = "fp32"):
    """Runs one step per ``(gt, ld)`` batch on the parameters ``names`` of
    ``model`` (in place).  Returns ``dict(losses=[...], grad1={name:
    clipped first gradient}, ema={name: EMA after the last step})``."""
    params = dict(model.named_parameters())
    train = [params[n] for n in names]
    gen = torch.Generator().manual_seed(seed)
    loss_fn = LOSSES[loss]
    m = [torch.zeros_like(p) for p in train]
    v = [torch.zeros_like(p) for p in train]
    ema = {n: p.detach().clone() for n, p in params.items()}
    out = dict(losses=[], grad1=None)
    for step, (gt, ld) in enumerate(batches):
        for p in train:
            p.grad = None
        micro = gt.shape[0] // accum
        total = 0.0
        with P.products(products):
            for i in range(accum):
                part = slice(i * micro, (i + 1) * micro)
                value = loss_fn(model, gt[part], ld[part], gen)
                (value / accum).backward()
                total += value.item() / accum
        out["losses"].append(total)
        with torch.no_grad():
            grads = [p.grad for p in train]
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            if norm >= max_norm:
                grads = [g / norm.float() * max_norm for g in grads]
            if step == 0:
                out["grad1"] = {n: g.clone() for n, g in zip(names, grads)}
            b1, b2 = betas
            for p, g, mi, vi in zip(train, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
                p.sub_(lr / c1 * mi / (vi.sqrt() / math.sqrt(c2) + eps))
            if step % 10 == 0:  # the EMA's counter is at most 100: a copy
                ema = {n: p.detach().clone() for n, p in params.items()}
    out["ema"] = ema
    return out
