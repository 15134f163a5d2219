"""The port's vanilla DDPM train step (CPU, plain versions) against the JAX
package at shared weights, on the micro ``VanillaUnet`` of
``tests/test_torch_vanilla.py`` (dim 8, mults (1, 2), 64^2: the bottleneck
``Attention`` on the flash route on both sides, its backward too).

- one ``Trainer.train_step`` (4 slices as 2 microbatches) against the JAX
  ``Trainer._step_fn`` with the same t and noise draws: the loss and every
  parameter's gradient.  The JAX optimizer is swapped for
  ``optax.scale(2^20)`` and clipping is off on both sides, so the step's
  parameter change is the gradient times 2^20;
- the bf16 step of a model with one output tensor, and ``Trainer.sample`` of
  the generation route.

Inputs from numpy seeds; fp32; rtol 1e-3 / atol 1e-4; gradients per
parameter at ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from founddiff_tpu.config import Config as JConfig
from founddiff_tpu.factory import build as j_build
from founddiff_tpu.models.vanilla_unet import VanillaUnet as JVanillaUnet
from founddiff_tpu.train.state import TrainState
from founddiff_tpu.train.trainer import Trainer as JTrainer
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.train.trainer import Trainer
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import (LEVEL1_COMPILE, check_param_grads, jit_quick, micro_vanilla_params,
                          np_, t_)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DIM, MULTS, SIZE = 8, (1, 2), 64
GRAD_SCALE = 2.0 ** 20


@pytest.fixture(scope="module")
def params():
    return micro_vanilla_params(JVanillaUnet(dim=DIM, dim_mults=MULTS, channels=1), seed=5)


def _configs(tmp_path, **train):
    jcfg, tcfg = JConfig(), Config()
    for cfg in (jcfg, tcfg):
        cfg.model.original_ddim_ddpm = True
        cfg.model.condition = False
        cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
        cfg.diffusion.image_size = SIZE
        cfg.train.checkpoint_folder = str(tmp_path)
        cfg.train.max_grad_norm = 1e9  # no clipping: the step's change is the gradient
    tcfg.train = dataclasses.replace(tcfg.train, **train)
    return jcfg, tcfg


def _port(tcfg, params):
    diffusion, model = build(tcfg, device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    return diffusion, model


def _batch(seed):
    return np.random.default_rng(seed).random((4, SIZE, SIZE, 1)).astype(np.float32)


def test_train_step_gradients_against_the_jax_step(params, tmp_path):
    jcfg, tcfg = _configs(tmp_path)
    jdiff, _, _ = j_build(jcfg, init=False)
    jtrainer = JTrainer(jdiff, params, jcfg)
    jtrainer.tx = optax.scale(GRAD_SCALE)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jtrainer.tx)
    gt = _batch(12)
    key = jax.random.PRNGKey(13)
    new_state, metrics = jit_quick(jtrainer._step_fn, LEVEL1_COMPILE)(
        state, (jnp.asarray(gt), jnp.asarray(gt)), key)
    grads_j = jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64)) / GRAD_SCALE,
        new_state.params, params)

    diffusion, model = _port(tcfg, params)
    trainer = Trainer(diffusion, model, tcfg)
    # t and the noise of each microbatch as the JAX step draws them
    # (founddiff_tpu/train/trainer.py:139, diffusion/gaussian.py:225-226, 258-259)
    draws = []
    for r in jax.random.split(jax.random.fold_in(key, 0), 2):
        r, t_rng = jax.random.split(r)
        t = jax.random.randint(t_rng, (2,), 0, 1000)
        noise = jax.random.normal(jax.random.split(r, 3)[1], (2, SIZE, SIZE, 1), jnp.float32)
        draws.append((torch.from_numpy(np.array(t)).long(), t_(noise)))
    loss = trainer._diffusion.loss
    trainer._diffusion.loss = lambda img, generator=None: loss(img, *draws.pop(0))
    losses = trainer.train_step((t_(gt), t_(gt)))
    assert not draws
    np.testing.assert_allclose(losses[0], float(metrics["loss_unet0"]), rtol=1e-3, atol=1e-4)
    check_param_grads(model, from_jax_params(grads_j))


def test_bf16_step_and_sample(params, tmp_path):
    """``mixed_precision="bf16"`` on a model with one output tensor; then
    ``Trainer.sample`` on the generation route (20 steps: DDPM)."""
    _, tcfg = _configs(tmp_path, mixed_precision="bf16", num_samples=2)
    tcfg.diffusion.timesteps = 20
    diffusion, model = _port(tcfg, params)
    trainer = Trainer(diffusion, model, tcfg)
    w = model.init_conv.weight
    w0 = w.detach().clone()
    gt = torch.from_numpy(_batch(14))
    losses = trainer.train_step((gt, gt))
    assert np.isfinite(losses[0]) and w.dtype == torch.float32
    assert not torch.equal(w.detach(), w0)
    out = trainer.sample(generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, SIZE, SIZE, 1) and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert np_(out).std() > 0
