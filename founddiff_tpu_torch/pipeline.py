"""Hoisted-tower serving (mirror of ``founddiff_tpu/pipeline.py:26-67``): DDIM,
or full-T ancestral sampling when ``sampling_timesteps == timesteps``.

The frozen Dose-CLIP tower depends only on the conditioning image, so it runs
once per slice and its embeddings are bound into every UNet call of the DDIM
loop (the reference recomputes it at every step, src/DADiff.py:692).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from founddiff_tpu_torch.diffusion.residual import (
    ResidualDiffusion,
    normalize_to_neg_one_to_one,
)


def make_hoisted_sampler(model, diffusion: ResidualDiffusion,
                         use_test_schedule: bool = True, last: bool = True,
                         compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns ``sample(x_input01, generator=None, noise=None) -> [B,H,W,C]``;
    ``noise`` as ``ddim_sample`` or ``p_sample_loop`` takes it.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the UNet trunk in that
    dtype: the input is cast at the model boundary and the predictions cast
    back to float32; weights are cast at use; the tower and the sampler's
    schedule math stay float32.
    """

    @torch.no_grad()
    def sample(x_input01, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        x_norm = normalize_to_neg_one_to_one(x_input01.float())
        dose, content = model.encode(x_norm)

        def bound_fn(x_in, time, x_self_cond=None):
            if compute_dtype is not None:
                x_in = x_in.to(compute_dtype)
            out = model(x_in, time, x_self_cond=x_self_cond, dose_embedding=dose,
                        content_embedding=content)
            if compute_dtype is not None:
                out = [o.float() for o in out]
            return out

        d = copy.copy(diffusion)
        d.model_fn = bound_fn
        sch = d.test_schedule if use_test_schedule else d.train_schedule
        sample_fn = d.ddim_sample if d.is_ddim_sampling else d.p_sample_loop
        out = sample_fn(x_norm, x_norm.shape, sch=sch, last=last, generator=generator,
                        noise=noise)
        return out[-1]

    return sample
