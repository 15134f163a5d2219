"""Hoisted-tower serving (mirror of ``founddiff_tpu/pipeline.py:26-125``): DDIM,
or full-T ancestral sampling when ``sampling_timesteps == timesteps``, and
full-volume denoising over a ('data', 'seq') mesh of ranks.

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
from founddiff_tpu_torch.utils import trace


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
    @trace.traced("serve.request", device=True)
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


def make_volume_denoiser(model, diffusion: ResidualDiffusion, mesh, batch_per_device: int = 1,
                         compute_dtype: Optional[torch.dtype] = None,
                         use_test_schedule: bool = True) -> Callable:
    """Full-volume CT denoising over ``mesh`` (``founddiff_tpu/pipeline.py:70-125``,
    BASELINE config 5).

    The slices of a ``[Z, H, W, 1]`` volume go through the hoisted sampler
    in waves of ``data x batch_per_device``; the volume is padded by
    repeating its last slice and the output cut back to Z.  Each data rank
    denoises its rows of a wave, and the outputs are all-gathered over the
    data group, so every rank returns the whole volume.  Where the mesh's
    seq axis has more than one rank, the model is cloned onto the mesh
    (``model.clone(mesh=mesh)``, weights shared) and every SS2D scan runs
    sequence-sharded over it.

    Returns ``denoise(volume01, generator=None, noise=None) -> [Z, H, W, 1]``.
    Each wave's initial noise is drawn at the wave's full shape from
    ``generator`` (seeded alike on every rank; by default seed 0) and the
    rank takes its rows, so the output does not depend on the mesh's shape;
    ``noise``, a sequence of per-wave ``[wave, H, W, 1]`` draws, replaces
    them (the tests hand in the JAX keys' normals).
    """
    if mesh.shape["seq"] > 1 and hasattr(model, "clone"):
        model = model.clone(mesh=mesh)
    wave = mesh.shape["data"] * batch_per_device
    rows = mesh.rows(wave)
    sampler = make_hoisted_sampler(model, diffusion, use_test_schedule=use_test_schedule,
                                   compute_dtype=compute_dtype)

    def denoise(volume01, generator: Optional[torch.Generator] = None, noise=None):
        z = volume01.shape[0]
        pad = (-z) % wave
        if pad:
            volume01 = torch.cat([volume01, volume01[-1:].expand(pad, *volume01.shape[1:])])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        outs = []
        for w, start in enumerate(range(0, z + pad, wave)):
            x = volume01[start:start + wave]
            draw = (noise[w] if noise is not None
                    else torch.randn(tuple(x.shape), generator=generator))
            out = sampler(x[rows], generator=generator, noise=draw[rows])
            outs.append(mesh.all_gather(out.contiguous(), "data"))
        return torch.cat(outs)[:z]

    return denoise
