"""The port's serving slice (CPU) against the JAX package at shared weights.

One micro FoundDiff (dim 32, dim_mults (1, 4), micro RN tower) whose mid and
up_0 MambaBlocks have C = 128, so the fused attention half is on the path.
JAX runs its ``chunked`` CPU route; the port runs the TPU routing with the
plain versions.  fp32 throughout; rtol 1e-3 / atol 1e-4 except the 2-step
DDIM image (atol 2e-3: two full UNet passes and the clip to [-1, 1] compound
the fp32 reassociation of the scans and convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.pipeline import make_hoisted_sampler as j_make_sampler
from founddiff_tpu.utils.torch_convert import convert_denoiser_params
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.pipeline import make_hoisted_sampler as t_make_sampler
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4
DIM, MULTS, SIZE = 32, (1, 4), 16


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jax_model():
    jm = JFoundDiff(dim=DIM, dim_mults=MULTS, scan_impl="chunked",
                    clip_overrides=MICRO_CLIP)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    params = jit_quick(jm.init)(jax.random.PRNGKey(4), x0, time0)["params"]
    return jm, perturb(params, seed=4)


@pytest.fixture(scope="module")
def port(jax_model):
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.diffusion.image_size = SIZE
    diffusion, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP)
    return diffusion, load_port(model, jax_model[1])


def _x01(seed, b=2):
    return np.random.default_rng(seed).random((b, SIZE, SIZE, 1)).astype(np.float32)


def test_tower_encode_and_dose_prob(jax_model, port):
    jm, params = jax_model
    model = port[1]
    x = _x01(11) * 2 - 1
    dose, content = jit_quick(lambda p, v: jm.apply({"params": p}, v, method="encode"))(
        params, jnp.asarray(x))
    tdose, tcontent = model.encode(t_(x))
    _close(tdose, dose)
    _close(tcontent, content)
    from founddiff_tpu.models.clip import CLIPIQA

    rgb = np.repeat(x, 3, axis=-1)
    want = jit_quick(CLIPIQA(**dict(MICRO_CLIP)).apply)({"params": params["dose_encoder"]},
                                                       jnp.asarray(rgb))
    for g, w in zip(model.dose_encoder(t_(rgb)), want):
        _close(g, w)


def test_unet_forward(jax_model, port):
    """UnetRes forward with given embeddings, and with the tower run inline."""
    jm, params = jax_model
    model = port[1]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, SIZE, SIZE, 2)).astype(np.float32)
    time = [rng.random(2).astype(np.float32) * 300, rng.random(2).astype(np.float32) * 30]
    dose = rng.standard_normal((2, 64)).astype(np.float32)
    content = rng.standard_normal((2, 1, 256)).astype(np.float32) * 0.1
    fwd = jit_quick(lambda p, *a, **k: jm.apply({"params": p}, *a, **k))
    want = fwd(params, jnp.asarray(x), [jnp.asarray(t) for t in time],
               dose_embedding=jnp.asarray(dose), content_embedding=jnp.asarray(content))
    got = model(t_(x), [t_(t) for t in time], dose_embedding=t_(dose),
                content_embedding=t_(content))
    _close(got[0], want[0])
    inline = fwd(params, jnp.asarray(x), [jnp.asarray(t) for t in time])
    _close(model(t_(x), [t_(t) for t in time])[0], inline[0])


def test_hoisted_two_step_ddim_slice(jax_model, port):
    jm, params = jax_model
    diffusion, model = port
    jd = JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s),
                    image_size=SIZE, timesteps=1000, sampling_timesteps=2,
                    objective="pred_res", condition=True, sum_scale=0.01,
                    test_res_or_noise="res")
    x01 = _x01(14)
    rng = jax.random.PRNGKey(6)
    want = jit_quick(j_make_sampler(jm, jd))(params, rng, jnp.asarray(x01))
    noise = jax.random.normal(jax.random.split(rng)[1], x01.shape)
    got = t_make_sampler(model, diffusion)(t_(x01), noise=t_(noise))
    assert got.shape == x01.shape and torch.isfinite(got).all()
    _close(got, want, atol=2e-3)


def test_from_jax_params_covers_state_dict(jax_model, port):
    sd = from_jax_params(jax_model[1])
    assert set(sd) == set(port[1].state_dict())


def test_weights_round_trip(jax_model, port):
    """port state_dict -> JAX converter (missing == []) -> from_jax_params
    gives back the same tensors: the port's names are the reference layout."""
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in port[1].state_dict().items()}
    torch_state = {"model." + k: v.numpy() for k, v in sd.items()}
    tree, _, missing = convert_denoiser_params(
        torch_state, jax_model[1], num_res=len(MULTS), clip_vision_layers=(1, 1, 1, 1),
        clip_transformer_layers=2)
    assert missing == []
    back = from_jax_params(tree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
