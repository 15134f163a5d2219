"""Optimizer of the train step (mirror of ``founddiff_tpu/train/state.py``).

optax's ``chain(clip_by_global_norm(max_norm), adam)`` for one UNet and
``radam`` for two (src/DADiff.py:1593-1602,1707): the clip is applied to the
gradients in place, then a ``torch.optim`` step.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: every gradient becomes ``g / norm *
    max_norm`` unless ``norm < max_norm`` (not ``clip_grad_norm_``'s
    ``max_norm / (norm + 1e-6)``).  Returns the global norm; no host sync."""
    grads: List[torch.Tensor] = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def make_optimizer(params, num_unet: int = 1, lr: float = 2e-4,
                   adam_betas=(0.9, 0.99)) -> torch.optim.Optimizer:
    """Adam(lr, betas, eps=1e-8) for one UNet (its ``m_hat / (sqrt(v_hat) +
    eps)`` is optax's ``adam``); RAdam(lr) with optax ``radam``'s defaults
    for two (two per-UNet RAdams equal one over the union)."""
    params = list(params)
    if num_unet == 1:
        return torch.optim.Adam(params, lr=lr, betas=tuple(adam_betas), eps=1e-8)
    return torch.optim.RAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
