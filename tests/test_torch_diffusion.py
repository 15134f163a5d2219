"""The port's diffusion core and package rules (CPU).

``ddim_sample`` against the JAX sampler with the same model function and the
same initial noise (JAX's draw handed to the port), and the residual
schedules against the JAX package's; fp32, rtol 1e-3 / atol 1e-4 (the
schedules bit-exact).  Then the package rules: no import of JAX or the JAX
package, and entry points that default to the card.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu import config as jconfig
from founddiff_tpu.diffusion import schedules as jsched
from founddiff_tpu_torch import config as tconfig
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion import schedules as tsched
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion as TDiffusion
from founddiff_tpu_torch.factory import build
from torch_parity import np_, t_

RTOL, ATOL = 1e-3, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _x01(seed, b=2, size=8):
    return np.random.default_rng(seed).random((b, size, size, 1)).astype(np.float32)


def _toy_fns(w):
    def jfn(params, x_in, time, x_self_cond=None):
        a = jnp.tanh(x_in[..., :1] * w + x_in[..., 1:2] * 0.3 + time[0][:, None, None, None] * 1e-3)
        return [a, jnp.sin(x_in[..., :1] + time[1][:, None, None, None] * 1e-2)]

    def tfn(x_in, time, x_self_cond=None):
        a = torch.tanh(x_in[..., :1] * w + x_in[..., 1:2] * 0.3 + time[0][:, None, None, None] * 1e-3)
        return [a, torch.sin(x_in[..., :1] + time[1][:, None, None, None] * 1e-2)]

    return jfn, tfn


@pytest.mark.parametrize("objective,res_or_noise,update", [
    ("pred_res", "res", "use_pred_noise"),
    ("pred_res", "res", "use_x_start"),
    ("pred_noise", "None", "use_pred_noise"),
    ("pred_x0_noise", "None", "use_pred_noise"),
    ("pred_res_noise", "res_noise", "use_pred_noise"),
    ("pred_res_noise", "noise", "use_x_start"),
])
def test_ddim_sample(objective, res_or_noise, update):
    """Same model function, same initial noise (JAX's draw handed to the port)."""
    jfn, tfn = _toy_fns(0.7)
    kw = dict(image_size=8, timesteps=1000, sampling_timesteps=5, objective=objective,
              condition=True, sum_scale=0.01, test_res_or_noise=res_or_noise,
              ddim_update=update)
    jd, td = JDiffusion(jfn, **kw), TDiffusion(tfn, **kw)
    x = _x01(13) * 2 - 1
    rng = jax.random.PRNGKey(5)
    noise = jax.random.normal(jax.random.split(rng)[1], x.shape)
    for last in (True, False):
        want = jd.ddim_sample(None, rng, jnp.asarray(x), x.shape, sch=jd.test_schedule,
                              last=last)
        got = td.ddim_sample(t_(x), x.shape, sch=td.test_schedule, last=last,
                             noise=t_(noise))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("test,ddim", [(False, True), (True, True), (False, False),
                                       (True, False)])
def test_residual_schedule(test, ddim):
    kw = dict(test=test, convert_to_ddim=ddim, sum_scale=0.01)
    want = jsched.make_residual_schedule(1000, **kw)
    got = tsched.make_residual_schedule(1000, **kw)
    for name in ("alphas", "alphas_cumsum", "one_minus_alphas_cumsum", "betas2",
                 "betas", "betas2_cumsum", "betas_cumsum", "posterior_mean_coef1",
                 "posterior_mean_coef2", "posterior_mean_coef3", "posterior_variance",
                 "posterior_log_variance_clipped"):
        np.testing.assert_array_equal(np_(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for steps in (2, 10, 50):
        assert [list(a) for a in tsched.ddim_time_pairs(1000, steps)] == \
            [list(map(int, a)) for a in jsched.ddim_time_pairs(1000, steps)]


@pytest.mark.parametrize("make", ["Config", "debug_config"])
def test_config_defaults(make):
    """Every field the port keeps has the JAX package's default."""
    import dataclasses

    got, want = getattr(tconfig, make)(), getattr(jconfig, make)()
    for part in ("model", "diffusion", "train"):
        for f in dataclasses.fields(getattr(got, part)):
            assert getattr(getattr(got, part), f.name) == getattr(getattr(want, part), f.name), \
                f"{part}.{f.name}"


def _port_sources():
    pkg = os.path.join(REPO, "founddiff_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "founddiff_tpu"}
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, f"{path} imports {n}"


def test_build_defaults_to_cuda():
    """Entry points run on the card unless asked for the CPU: no silent CPU
    fallback on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(Config())
