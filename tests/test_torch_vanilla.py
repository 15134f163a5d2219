"""The port's vanilla DDPM path (CPU, plain versions) against the JAX package
at shared weights.

- the blocks: ``ChanLayerNorm``, ``LinearAttention``, ``Attention`` on the
  flash route (the JAX side in Pallas interpret mode) and on the plain
  product, ``TimeResnetBlock`` with its time scale/shift;
- the micro ``VanillaUnet`` (dim 8, mults (1, 2), 64^2, so the bottleneck
  ``Attention`` runs at 32^2, L = 1024, on the flash route on both sides):
  its JAX param tree loads strictly under lucidrains names, then the forward
  and every parameter's gradient;
- ``make_gaussian_schedule``, ``q_sample``, ``loss``/``p_losses`` of every
  objective and loss type with the JAX package's own t and noise draws
  handed in, ``ddim_sample`` and a short ``p_sample_loop`` with every draw
  handed in, around a closed-form model;
The train step is in ``tests/test_torch_vanilla_train.py``.

Inputs from numpy seeds; fp32; rtol 1e-3 / atol 1e-4.  Parameter gradients
are held per parameter at ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-6, as in
``tests/test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.diffusion.gaussian import GaussianDiffusion as JGaussian
from founddiff_tpu.diffusion.schedules import make_gaussian_schedule as j_schedule
from founddiff_tpu.models.blocks import Attention as JAttention
from founddiff_tpu.models.blocks import ChanLayerNorm as JChanLayerNorm
from founddiff_tpu.models.blocks import LinearAttention as JLinearAttention
from founddiff_tpu.models.vanilla_unet import TimeResnetBlock as JTimeResnetBlock
from founddiff_tpu.models.vanilla_unet import VanillaUnet as JVanillaUnet
from founddiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from founddiff_tpu_torch.diffusion.schedules import make_gaussian_schedule
from founddiff_tpu_torch.models.blocks import Attention, ChanLayerNorm, LinearAttention
from founddiff_tpu_torch.models.vanilla_unet import TimeResnetBlock, VanillaUnet
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import check_param_grads, jit_quick, micro_vanilla_params, np_, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
DIM, MULTS, SIZE = 8, (1, 2), 64


def _close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _jitter(tree, seed, std=0.1):
    """Every leaf plus N(0, std): the norms' unit scales and zero biases
    would hide a misplaced affine."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(np.shape(a)) * std).astype(np.float32),
        tree)


def _load_block(module, name, jax_params, prefix):
    """A JAX block's params placed at ``name`` of a vanilla tree, converted,
    and loaded strictly into the port block found at ``prefix``."""
    sd = from_jax_params({name: jax_params}, vanilla=True)
    assert all(k.startswith(prefix) for k in sd), sorted(sd)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _x(seed, shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# --- blocks ------------------------------------------------------------------


def test_chan_layer_norm():
    x = _x(0, (2, 5, 6, 16)) + 0.5
    jm = JChanLayerNorm(16)
    p = _jitter(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    port = _load_block(ChanLayerNorm(16), "down_0_attn_norm", p, "downs.0.2.fn.norm.")
    assert port.g.shape == (1, 16, 1, 1)
    _close(port(t_(x)), jm.apply({"params": p}, jnp.asarray(x)))


def test_linear_attention():
    x = _x(1, (2, 6, 8, 16))
    jm = JLinearAttention(16)
    p = _jitter(jit_quick(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 2)
    port = _load_block(LinearAttention(16), "down_0_attn", p, "downs.0.2.fn.fn.")
    _close(port(t_(x)), jit_quick(jm.apply)({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize("use_flash", [True, False])
def test_attention_routes(use_flash):
    x = _x(2, (2, 8, 8, 16))
    jm = JAttention(16, use_flash=use_flash)
    p = _jitter(jit_quick(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 3)
    port = _load_block(Attention(16, use_flash=use_flash), "mid_attn", p, "mid_attn.fn.fn.")
    _close(port(t_(x)), jit_quick(jm.apply)({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize("c_in,c_out", [(8, 16), (16, 16)])
def test_time_resnet_block(c_in, c_out):
    x, temb = _x(3, (2, 6, 6, c_in)), _x(4, (2, 32))
    jm = JTimeResnetBlock(c_out, groups=8)
    p = _jitter(jit_quick(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(temb))[
        "params"], 4)
    port = _load_block(TimeResnetBlock(c_in, c_out, time_dim=32), "down_0_block1", p,
                       "downs.0.0.")
    assert (port.res_conv is None) == (c_in == c_out)
    want = jit_quick(jm.apply)({"params": p}, jnp.asarray(x), jnp.asarray(temb))
    _close(port(t_(x), t_(temb)), want)


# --- the micro VanillaUnet --------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    jm = JVanillaUnet(dim=DIM, dim_mults=MULTS, channels=1)
    return jm, micro_vanilla_params(jm, seed=5)


def _port_unet(params):
    model = VanillaUnet(DIM, MULTS, channels=1)
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


def test_lucidrains_names(micro):
    sd = from_jax_params(micro[1])
    assert set(sd) == set(VanillaUnet(DIM, MULTS, channels=1).state_dict())
    for key in ("downs.0.0.mlp.1.weight", "downs.0.1.block2.norm.weight",
                "downs.0.2.fn.fn.to_qkv.weight", "downs.0.2.fn.fn.to_out.0.bias",
                "downs.0.2.fn.fn.to_out.1.g", "downs.0.2.fn.norm.g", "downs.0.3.weight",
                "mid_block1.block1.proj.weight", "mid_attn.fn.fn.to_out.weight",
                "mid_attn.fn.norm.g", "ups.0.0.res_conv.weight", "ups.0.3.1.weight",
                "ups.1.3.weight", "time_mlp.3.bias", "final_res_block.res_conv.weight",
                "final_conv.weight"):
        assert key in sd, key


def test_micro_unet_forward_and_parameter_gradients(micro):
    jm, params = micro
    x = _x(6, (2, SIZE, SIZE, 1))
    t = np.asarray([17.0, 803.0], np.float32)
    w = _x(7, (2, SIZE, SIZE, 1))

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean(out * jnp.asarray(w)), out

    (_, out_j), grads_j = jit_quick(jax.value_and_grad(loss, has_aux=True))(params)
    model = _port_unet(params).requires_grad_(True)
    out = model(t_(x), t_(t))
    _close(out, out_j)
    (out * t_(w)).mean().backward()
    check_param_grads(model, from_jax_params(grads_j))


# --- the diffusion process ---------------------------------------------------


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine"])
def test_gaussian_schedule(beta_schedule):
    want = j_schedule(200, beta_schedule=beta_schedule, p2_loss_weight_gamma=0.5,
                      p2_loss_weight_k=1.0)
    got = make_gaussian_schedule(200, beta_schedule=beta_schedule, p2_loss_weight_gamma=0.5)
    for f in dataclasses.fields(got):
        if f.name == "num_timesteps":
            assert got.num_timesteps == want.num_timesteps == 200
            continue
        a = getattr(got, f.name)
        assert a.dtype == torch.float32, f.name
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(want, f.name)), rtol=1e-6,
                                   atol=0, err_msg=f.name)


def _closed_form(x, t):
    """A model with a nonlinearity in x and a dependence on t, the same on both sides."""
    tt = t.astype(jnp.float32) if hasattr(t, "astype") else t.float()
    lib = jnp if hasattr(x, "at") else torch
    return lib.tanh(x * 0.8) * 0.9 + tt[:, None, None, None] * 1e-3


def _pair(**kw):
    kw = dict(image_size=8, channels=1, **kw)
    return (JGaussian(lambda p, x, t, s=None: _closed_form(x, t), **kw),
            GaussianDiffusion(lambda x, t, s=None: _closed_form(x, t), **kw, device="cpu"))


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_loss_with_the_jax_draws(objective, loss_type):
    jd, td = _pair(timesteps=1000, objective=objective, loss_type=loss_type,
                   p2_loss_weight_gamma=0.5)
    img = np.random.default_rng(8).random((3, 8, 8, 1)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    want = jd.loss(None, rng, jnp.asarray(img))
    rng, t_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (3,), 0, 1000)
    noise = jax.random.normal(jax.random.split(rng, 3)[1], img.shape, dtype=jnp.float32)
    tt = torch.from_numpy(np.array(t)).long()
    _close(td.loss(t_(img), t=tt, noise=t_(noise)), want)
    x0 = t_(img) * 2 - 1
    _close(td.q_sample(x0, tt, t_(noise)), jd.q_sample(jnp.asarray(np_(x0)), t, noise))


def _jax_draws(rng, steps, shape):
    """The initial image and the per-step draws of the JAX samplers."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape)]
    for _ in range(steps):
        rng, noise_rng = jax.random.split(rng)
        draws.append(jax.random.normal(noise_rng, shape, dtype=jnp.float32))
    return [t_(d) for d in draws]


def test_ddim_sample_with_the_jax_draws():
    jd, td = _pair(timesteps=20, sampling_timesteps=4, ddim_sampling_eta=1.0)
    shape, rng = (2, 8, 8, 1), jax.random.PRNGKey(10)
    assert jd.is_ddim_sampling and td.is_ddim_sampling
    want = jd.ddim_sample(None, rng, shape)
    got = td.sample(batch_size=2, noise=_jax_draws(rng, 4, shape))
    _close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_p_sample_loop_with_the_jax_draws():
    jd, td = _pair(timesteps=5)
    shape, rng = (2, 8, 8, 1), jax.random.PRNGKey(11)
    assert not td.is_ddim_sampling
    want = jd.p_sample_loop(None, rng, shape)
    _close(td.sample(batch_size=2, noise=_jax_draws(rng, 5, shape)), want)
