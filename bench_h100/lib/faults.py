"""Faults planted in the system under test, for the check that each one
makes ``correct`` come out false.  Each is a context manager that patches
the program for the body and restores it; the cells that can have a fault
list it in ``FAULTS``."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def answer_altered():
    """Serving: the first slice of every request comes back with a 32x32
    patch 0.05 brighter."""
    import founddiff_tpu_torch.pipeline as pipeline

    def make(old):
        def factory(*a, **kw):
            sample = old(*a, **kw)

            def altered(*args, **kwargs):
                out = sample(*args, **kwargs).clone()
                out[0, :32, :32] += 0.05
                return out
            return altered
        return factory
    return _patched(pipeline, "make_hoisted_sampler", make)


def tower_low_precision():
    """Serving: the tower run in bfloat16 (its input cast, as a bf16 train
    step runs it), its embeddings cast back to float32."""
    from founddiff_tpu_torch.models.founddiff import FoundDiffDenoiser

    def make(old):
        def encode(self, x_input):
            dose, content = old(self, x_input.to(torch.bfloat16))
            return dose.float(), content.float()
        return encode
    return _patched(FoundDiffDenoiser, "encode", make)


def state_unchanged():
    """Training: the step returns its state unchanged: the parameters and
    the EMA as they were before it."""
    from founddiff_tpu_torch.train.trainer import Trainer

    def make(old):
        def train_step(self, batch):
            state = list(self.model.parameters()) + list(self.ema.parameters())
            saved = [p.detach().clone() for p in state]
            out = old(self, batch)
            with torch.no_grad():
                for p, s in zip(state, saved):
                    p.copy_(s)
            return out
        return train_step
    return _patched(Trainer, "train_step", make)


def half_batch():
    """Training: each microbatch's loss over its first half of rows only."""
    from founddiff_tpu_torch.train.trainer import Trainer

    def make(old):
        def train_step(self, batch):
            loss = self._diffusion.loss

            def half(imgs, **kw):
                cut = lambda x: x[: max(1, x.shape[0] // 2)]
                imgs = [cut(x) for x in imgs] if isinstance(imgs, (list, tuple)) else cut(imgs)
                return loss(imgs, **kw)
            self._diffusion.loss = half
            try:
                return old(self, batch)
            finally:
                del self._diffusion.loss
        return train_step
    return _patched(Trainer, "train_step", make)


def gradient_altered():
    """Training: the gradient of the largest leaf doubled before the clip."""
    from founddiff_tpu_torch.train import trainer as trainer_module

    def make(old):
        def clip(params, max_norm):
            params = list(params)
            big = max((p for p in params if p.grad is not None), key=lambda p: p.numel())
            big.grad.mul_(2.0)
            return old(params, max_norm)
        return clip
    return _patched(trainer_module, "clip_by_global_norm_", make)


FAULTS = {"serve_closed": {"answer_altered": answer_altered,
                           "tower_low_precision": tower_low_precision},
          "train_steps": {"state_unchanged": state_unchanged, "half_batch": half_batch,
                          "gradient_altered": gradient_altered}}
