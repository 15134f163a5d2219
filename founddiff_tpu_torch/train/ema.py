"""EMA with ema_pytorch's semantics (mirror of ``founddiff_tpu/train/ema.py``).

The reference keeps ``ema_pytorch.EMA(beta=0.995, update_every=10)`` of the
whole diffusion model (src/DADiff.py:1606-1608, train.py:140):

- every trainer step calls ``update()`` once; the counter is read before it
  is incremented;
- a blend happens only on steps where ``counter % update_every == 0``;
- the decay is 0 (a copy) up to ``update_after_step`` (100);
- then ``1 - (1 + epoch / inv_gamma) ** -power`` clamped to
  ``[min_value, beta]``, with ``epoch = counter - update_after_step - 1``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from founddiff_tpu_torch.utils import trace


def ema_decay_schedule(step: int, beta: float = 0.995, update_after_step: int = 100,
                       inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
                       min_value: float = 0.0) -> float:
    """Decay at call counter ``step`` (pre-increment), in float32 as the JAX
    schedule computes it."""
    if step <= update_after_step:
        return 0.0
    f = np.float32
    epoch = max(f(step) - f(update_after_step) - f(1), f(0))
    value = f(1) - (f(1) + epoch / f(inv_gamma)) ** f(-power)
    return float(np.clip(value, f(min_value), f(beta)))


@torch.no_grad()
def ema_update(ema_tensors: Iterable[torch.Tensor], tensors: Iterable[torch.Tensor],
               step: int, beta: float = 0.995, update_every: int = 10,
               update_after_step: int = 100, inv_gamma: float = 1.0,
               power: float = 2.0 / 3.0, min_value: float = 0.0) -> int:
    """Blend ``ema = ema * decay + p * (1 - decay)`` in place at counter
    ``step`` when ``step % update_every == 0``; returns ``step + 1``.  A blend runs inside
    the span ``train.ema``."""
    if step % update_every == 0:
        decay = ema_decay_schedule(step, beta, update_after_step, inv_gamma, power, min_value)
        with trace.span("train.ema", device=True):
            for e, p in zip(ema_tensors, tensors):
                e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))
    return step + 1
