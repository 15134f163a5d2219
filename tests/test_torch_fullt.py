"""Full-T ancestral sampling of the port (``ResidualDiffusion.p_sample_loop``,
``sample()`` and the hoisted sampler at ``sampling_timesteps ==
timesteps``) against the JAX package at shared weights: the micro models of
``test_torch_eval.py`` at T = 10 on 16^2 slices, fp32, every draw of the
JAX ``lax.scan`` handed in; every image within rtol 1e-3 / atol 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.pipeline import make_hoisted_sampler as j_make_sampler
from founddiff_tpu_torch.pipeline import make_hoisted_sampler as t_make_sampler
from test_torch_eval import (IMG_ATOL, SIZE, _close, _compiled_once, _jax_diffusion,
                             _jax_model, _port)
from torch_parity import jit_quick, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

T = 10


def _scan_draws(rng, steps, shape):
    """The draws of the JAX samplers' ``lax.scan``: the initial normal from
    ``split(rng)``'s second key, then one per step, each from the second key
    of a split of the carried key."""
    rng, init = jax.random.split(rng)
    draws = [jax.random.normal(init, shape)]
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        draws.append(jax.random.normal(k, shape))
    return [t_(d) for d in draws]


@pytest.fixture(scope="module")
def no_tower():
    """The no-tower micro UnetRes at T = 10 and the JAX ``p_sample_loop``
    compiled once with the schedule as an argument, every image kept."""
    jm, params = _jax_model(False)
    jd = _jax_diffusion(jm, timesteps=T, sampling=T)
    _, diffusion, model = _port(False, params, "unused", timesteps=T, sampling=T)
    model.eval()
    loop = _compiled_once(jax.jit(
        lambda p, r, x, sch: jd.p_sample_loop(p, r, x * 2.0 - 1.0, x.shape, sch=sch,
                                              last=False)))
    return jd, params, diffusion, loop


@pytest.mark.parametrize("test_schedule", [True, False])
def test_p_sample_loop_and_sample(no_tower, test_schedule):
    """``sample()`` takes ``p_sample_loop`` at full T: with ``last=False``
    the noised input and all T images, with ``last=True`` the first and the
    last of them; ``p_sample_loop`` on normalised inputs gives the same."""
    jd, params, diffusion, loop = no_tower
    assert not diffusion.is_ddim_sampling
    x01 = np.random.default_rng(3).random((2, SIZE, SIZE, 1), dtype=np.float32)
    rng = jax.random.PRNGKey(11)
    jsch = jd.test_schedule if test_schedule else jd.train_schedule
    want = loop(params, rng, jnp.asarray(x01), jsch)
    draws = _scan_draws(rng, T, x01.shape)
    every = diffusion.sample(t_(x01), last=False, use_test_schedule=test_schedule, noise=draws)
    assert len(every) == len(want) == 1 + T
    for g, w in zip(every, want):
        _close(g, w, atol=IMG_ATOL)
    last = diffusion.sample(t_(x01), use_test_schedule=test_schedule, noise=draws)
    assert len(last) == 2
    for g, e in zip(last, (every[0], every[-1])):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    sch = diffusion.test_schedule if test_schedule else diffusion.train_schedule
    direct = diffusion.p_sample_loop(t_(x01) * 2 - 1, x01.shape, sch=sch, noise=draws)
    for g, d in zip(last, direct):
        torch.testing.assert_close(g, d, rtol=0, atol=0)


def test_p_sample_loop_draws(no_tower):
    """The initial noise alone, the step draws then from the generator; a
    wrong count of draws is refused."""
    _, _, diffusion, _ = no_tower
    x = torch.zeros(1, SIZE, SIZE, 1)
    init = torch.randn(1, SIZE, SIZE, 1, generator=torch.Generator().manual_seed(1))
    a = diffusion.p_sample_loop(x, x.shape, noise=init, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(2)
    rest = [torch.randn(1, SIZE, SIZE, 1, generator=gen) for _ in range(T)]
    b = diffusion.p_sample_loop(x, x.shape, noise=[init] + rest)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        diffusion.p_sample_loop(x, x.shape, noise=[init] * 3)


def test_posteriors(no_tower):
    """``q_posterior`` and ``q_posterior_from_res_noise`` on both schedules
    at every t, against JAX (rtol 1e-5)."""
    jd, _, diffusion, _ = no_tower
    rng = np.random.default_rng(5)
    x_t, res, x0, noise = (rng.standard_normal((T, 4, 4, 1)).astype(np.float32)
                           for _ in range(4))
    t = np.arange(T)
    for jsch, sch in ((jd.train_schedule, diffusion.train_schedule),
                      (jd.test_schedule, diffusion.test_schedule)):
        want = jd.q_posterior(jsch, jnp.asarray(res), jnp.asarray(x0), jnp.asarray(x_t),
                              jnp.asarray(t))
        got = diffusion.q_posterior(sch, t_(res), t_(x0), t_(x_t), torch.from_numpy(t))
        for g, w in zip(got, want):
            _close(g, np.broadcast_to(np.asarray(w), g.shape), rtol=1e-5, atol=1e-6)
        want = jd.q_posterior_from_res_noise(jsch, jnp.asarray(res), jnp.asarray(noise),
                                             jnp.asarray(x_t), jnp.asarray(t))
        got = diffusion.q_posterior_from_res_noise(sch, t_(res), t_(noise), t_(x_t),
                                                   torch.from_numpy(t))
        _close(got, want, rtol=1e-5, atol=1e-6)


def test_hoisted_sampler_full_t():
    """``make_hoisted_sampler`` at full T with the micro tower takes
    ``p_sample_loop`` (it used to refuse), against the JAX sampler."""
    jm, params = _jax_model(True)
    jd = _jax_diffusion(jm, timesteps=T, sampling=T)
    _, diffusion, model = _port(True, params, "unused", timesteps=T, sampling=T)
    x01 = np.random.default_rng(4).random((1, SIZE, SIZE, 1), dtype=np.float32)
    rng = jax.random.PRNGKey(12)
    want = jit_quick(j_make_sampler(jm, jd))(params, rng, jnp.asarray(x01))
    got = t_make_sampler(model.eval(), diffusion)(t_(x01), noise=_scan_draws(rng, T, x01.shape))
    assert got.shape == x01.shape
    _close(got, want, atol=IMG_ATOL)
