"""The port's bf16 serving path against the JAX package's bf16 recipe.

The micro FoundDiff of ``tests/test_torch_slice.py`` (dim 32 x (1, 4), micro
RN tower) with adaLN and prompt drawn from N(0, 0.2), so that every
MambaBlock gate is live; hoisted-tower DDIM-2 on two 16^2 slices.  JAX
follows ``bench.py:101-112``: the UNet's params cast to bf16 (the tower's
stay fp32) and ``compute_dtype=jnp.bfloat16``.  The port loads the fp32
tree and serves with ``compute_dtype=torch.bfloat16``, casting weights at
use.  The two bf16 paths round at different places (the port computes the
adaLN modulation in fp32 from fp32 weights), so the bound is a PSNR floor
of 45 dB on the [0, 1] output, well below what they reach, and far above
what a dtype fault gives.

Reference caveat: JAX's ``make_hoisted_sampler`` with
``compute_dtype=jnp.bfloat16`` and fp32 params promotes the trunk to fp32
from the first MambaBlock on (flax ``nn.Dense`` gives the adaLN gates in
fp32).  The port follows the bench recipe, not that case.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.pipeline import make_hoisted_sampler as j_make_sampler
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.pipeline import make_hoisted_sampler as t_make_sampler
from torch_parity import MICRO_CLIP, jit_quick, load_port, np_, perturb, t_

DIM, MULTS, SIZE = 32, (1, 4), 16
PSNR_FLOOR_DB = 45.0


def test_bf16_ddim_two_step_against_the_jax_bf16_recipe():
    jm = JFoundDiff(dim=DIM, dim_mults=MULTS, scan_impl="chunked", clip_overrides=MICRO_CLIP)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(4), x0, time0)["params"], seed=4,
                     std=0.2)
    bf16 = dict(params, model=jax.tree_util.tree_map(
        lambda p: jnp.asarray(p).astype(jnp.bfloat16), params["model"]))
    jd = JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s),
                    image_size=SIZE, timesteps=1000, sampling_timesteps=2,
                    objective="pred_res", condition=True, sum_scale=0.01,
                    test_res_or_noise="res")
    x01 = np.random.default_rng(15).random((2, SIZE, SIZE, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    want = jit_quick(j_make_sampler(jm, jd, compute_dtype=jnp.bfloat16))(
        bf16, rng, jnp.asarray(x01))
    noise = jax.random.normal(jax.random.split(rng)[1], x01.shape)

    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.diffusion.image_size = SIZE
    diffusion, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP)
    load_port(model, params)
    got = t_make_sampler(model, diffusion, compute_dtype=torch.bfloat16)(
        t_(x01), noise=t_(noise))
    assert got.shape == x01.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    mse = float(np.mean((np_(got) - np.asarray(want, np.float32)) ** 2))
    psnr = math.inf if mse == 0 else 10 * math.log10(1.0 / mse)
    assert psnr >= PSNR_FLOOR_DB, psnr
