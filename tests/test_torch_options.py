"""The model and diffusion options of the port that the default build does
not take, against the JAX package on the CPU.

- ``input_condition_mask`` in ``loss`` and ``sample`` (only the image and
  the input normalised, the condition as given), with a closed-form model on
  both sides, ``t`` and the noise drawn as JAX draws them;
- ``learned_variance``, ``init_dim`` and the learned or random sinusoidal
  time embedding on the FoundDiff ``Unet`` and on ``VanillaUnet`` (micro
  widths, 16^2, params from the JAX shapes filled from a numpy seed and
  loaded strictly through ``from_jax_params``); the random embedding's
  weights take no gradient on either side;
- ``learned_variance`` downstream: through the factories of both packages
  (the no-tower ``UnetRes`` and the vanilla path) the loss broadcasts the
  two-channel output and agrees, and sampling raises a ``TypeError`` on
  both sides; the FoundDiff factory keeps ``learned_variance=False`` with a
  warning;
- the Config JSON with the two new fields, in both directions.

fp32; rtol 1e-3 / atol 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.config import Config as JConfig
from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.factory import build as jbuild
from founddiff_tpu.models.blocks import RandomOrLearnedSinusoidalPosEmb as JPosEmb
from founddiff_tpu.models.unet import Unet as JUnet
from founddiff_tpu.models.vanilla_unet import VanillaUnet as JVanillaUnet
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion as TDiffusion
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.models.blocks import RandomOrLearnedSinusoidalPosEmb
from founddiff_tpu_torch.models.unet import Unet
from founddiff_tpu_torch.models.vanilla_unet import VanillaUnet
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import filled_params, jit_quick, load_port, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
SIZE = 16


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _images(seed, n, b=2):
    rng = np.random.default_rng(seed)
    return [rng.random((b, SIZE, SIZE, 1)).astype(np.float32) for _ in range(n)]


def _model(x_in, time):
    """A closed form of the three input channels (noisy, input, condition)."""
    return [x_in[..., :1] * 0.6 - x_in[..., 1:2] * 0.2 + x_in[..., 2:3] * 0.5
            + time[0][:, None, None, None] * 1e-3]


def _diffusions(mask):
    kw = dict(image_size=SIZE, timesteps=1000, sampling_timesteps=2, loss_type="l2",
              objective="pred_res", condition=True, sum_scale=0.01, test_res_or_noise="res",
              input_condition=True, input_condition_mask=mask)
    return (JDiffusion(lambda p, x, t, s=None: _model(x, t), **kw),
            TDiffusion(lambda x, t, s=None: _model(x, t), **kw, device="cpu"))


@pytest.mark.parametrize("mask", [False, True])
def test_input_condition_mask_in_loss(mask):
    jd, td = _diffusions(mask)
    imgs = _images(3, 3)
    key = jax.random.PRNGKey(9)
    want = jd.loss(None, key, [jnp.asarray(i) for i in imgs])
    rng, t_rng = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 1000))).long()
    noise = t_(jax.random.normal(jax.random.split(rng, 4)[1], imgs[0].shape))
    got = td.loss([t_(i) for i in imgs], t=t, noise=noise)
    _close(got[0], want[0])
    if mask:  # the condition is not normalised: another loss than without the mask
        other = _diffusions(False)[1].loss([t_(i) for i in imgs], t=t, noise=noise)
        assert abs(float(other[0]) - float(got[0])) > 1e-4


@pytest.mark.parametrize("mask", [False, True])
def test_input_condition_mask_in_sample(mask):
    jd, td = _diffusions(mask)
    x, cond = _images(4, 2)
    key = jax.random.PRNGKey(10)
    want = jd.sample(None, key, [jnp.asarray(x), jnp.asarray(cond)], use_test_schedule=True)
    noise = t_(jax.random.normal(jax.random.split(key)[1], x.shape))
    got = td.sample([t_(x), t_(cond)], use_test_schedule=True, noise=noise)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w)


# (family, options): the FoundDiff Unet takes the embedding options only as
# a bare Unet, as in the JAX package (its UnetRes passes learned_variance on)
UNET_CASES = [
    ("founddiff", dict(learned_sinusoidal_cond=True, learned_variance=True, init_dim=16)),
    ("vanilla", dict(random_fourier_features=True, learned_variance=True, init_dim=16)),
    ("vanilla", dict(learned_sinusoidal_cond=True, learned_sinusoidal_dim=11, out_dim=3)),
]


@pytest.mark.parametrize("family,opts", UNET_CASES,
                         ids=[f"{f}-{'-'.join(o)}" for f, o in UNET_CASES])
def test_unet_options(family, opts):
    rng = np.random.default_rng(5)
    t = np.asarray([17.0, 803.0], np.float32)
    if family == "founddiff":
        x = rng.standard_normal((2, SIZE, SIZE, 2)).astype(np.float32)
        dose = rng.standard_normal((2, 64)).astype(np.float32)
        content = (rng.standard_normal((2, 1, 256)) * 0.1).astype(np.float32)
        jm = JUnet(dim=8, dim_mults=(1, 2), channels=1, condition=True, context_dim=64,
                   scan_impl="chunked", **opts)
        params = perturb(filled_params(jm, 6, jnp.asarray(x), jnp.asarray(t)), seed=6)
        kw = dict(dose_embedding=dose, content_embedding=content)
        port = load_port(Unet(8, (1, 2), channels=1, condition=True, context_dim=64, **opts),
                         params)
    else:
        x = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
        jm = JVanillaUnet(dim=8, dim_mults=(1, 2), channels=1, **opts)
        params = filled_params(jm, 6, jnp.asarray(x), jnp.asarray(t))
        kw = {}
        port = load_port(VanillaUnet(8, (1, 2), channels=1, **opts), params)
    want = jit_quick(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = port(t_(x), t_(t), **{k: t_(v) for k, v in kw.items()})
    out_ch = opts.get("out_dim") or (2 if opts.get("learned_variance") else 1)
    assert got.shape == want.shape == (2, SIZE, SIZE, out_ch)
    _close(got, want)
    assert port.init_conv.weight.shape[0] == opts.get("init_dim", 8)
    assert "time_mlp.0.weights" in from_jax_params(params, vanilla=family == "vanilla")


@pytest.mark.parametrize("is_random", [False, True])
def test_sinusoidal_embedding_gradient(is_random):
    """[t, sin, cos] at dim 16 (and 15: the width 2 * (dim // 2) + 1), and
    d(sum(out * w))/d(weights): zero on both sides for the random features."""
    t = np.asarray([0.3, 5.0, 711.0], np.float32)
    for dim in (16, 15):
        jm = JPosEmb(dim, is_random=is_random)
        params = filled_params(jm, dim, jnp.asarray(t))
        w = np.random.default_rng(dim).standard_normal((3, 2 * (dim // 2) + 1)).astype(
            np.float32)
        loss = lambda p: (jm.apply({"params": p}, jnp.asarray(t)) * w).sum()
        jg = jax.grad(loss)(params)["weights"]
        port = RandomOrLearnedSinusoidalPosEmb(dim, is_random=is_random)
        port.load_state_dict(from_jax_params(params), strict=True)
        port.weights.requires_grad_(True)  # as build(train=True) sets every parameter
        out = port(t_(t))
        _close(out, jm.apply({"params": params}, jnp.asarray(t)))
        if is_random:  # nothing in the output's graph: no gradient reaches w
            assert not out.requires_grad and not np.any(np.asarray(jg))
        else:
            (out * t_(w)).sum().backward()
            _close(port.weights.grad, jg)


def _factory_configs(vanilla):
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.model.dim, c.model.dim_mults, c.model.learned_variance = 8, (1, 2), True
        c.diffusion.image_size = SIZE
        if vanilla:
            c.model.original_ddim_ddpm, c.model.condition = True, False
        else:
            c.model.use_dose_encoder = False
    return cfg, jcfg


@pytest.mark.parametrize("vanilla", [False, True], ids=["unetres", "vanilla"])
def test_learned_variance_downstream(vanilla):
    """The two-channel output through each package's factory: the loss
    broadcasts it against the one-channel target on both sides and agrees;
    a sample raises TypeError on both (the JAX scan refuses a carry that
    changes shape)."""
    cfg, jcfg = _factory_configs(vanilla)
    jd, jm, _ = jbuild(jcfg, init=False)
    x0 = jnp.zeros((1, SIZE, SIZE, 1 if vanilla else 2))
    t0 = jnp.zeros((1,))
    params = perturb(filled_params(jm, 2, x0, t0 if vanilla else [t0, t0]), seed=2)
    td, model = build(cfg, device="cpu", seed=0)
    model.load_state_dict(from_jax_params(params), strict=True)
    imgs = _images(8, 1 if vanilla else 2)
    key = jax.random.PRNGKey(12)
    rng, t_rng = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 1000))).long()
    jloss = jit_quick(lambda p, k, i: jd.loss(p, k, i))
    if vanilla:
        want = jloss(params, key, jnp.asarray(imgs[0]))
        noise = t_(jax.random.normal(jax.random.split(rng, 3)[1], imgs[0].shape))
        got = td.loss(t_(imgs[0]), t=t, noise=noise)
    else:
        want = jloss(params, key, [jnp.asarray(i) for i in imgs])[0]
        noise = t_(jax.random.normal(jax.random.split(rng, 4)[1], imgs[0].shape))
        got = td.loss([t_(i) for i in imgs], t=t, noise=noise)[0]
    with torch.no_grad():
        x0_t, t0_t = torch.zeros(x0.shape), torch.zeros(1)
        out = model(x0_t, t0_t) if vanilla else model(x0_t, [t0_t, t0_t])[0]
    assert out.shape[-1] == 2
    _close(got, want)
    x = jnp.asarray(imgs[-1])
    with pytest.raises(TypeError):
        if vanilla:
            jd.sample(params, jax.random.PRNGKey(1), batch_size=1)
        else:
            jd.sample(params, jax.random.PRNGKey(1), x, use_test_schedule=True)
    with pytest.raises(TypeError):
        with torch.no_grad():
            if vanilla:
                td.sample(batch_size=1, generator=torch.Generator().manual_seed(1))
            else:
                td.sample(t_(imgs[-1]), use_test_schedule=True,
                          generator=torch.Generator().manual_seed(1))


def test_founddiff_factory_keeps_learned_variance_off():
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults, cfg.model.learned_variance = 8, (1, 2), True
    cfg.diffusion.image_size = SIZE
    from torch_parity import MICRO_CLIP

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP)
    assert any("learned_variance=False" in str(w.message) for w in seen)
    assert model.unet0.final_conv.weight.shape[0] == 1


def test_config_json_with_the_new_fields():
    t = Config()
    t.model.input_condition_mask, t.model.learned_variance = True, True
    j = JConfig.from_json(t.to_json())
    assert j.model.input_condition_mask and j.model.learned_variance
    back = Config.from_json(j.to_json())
    assert back == t
    assert Config.from_json(JConfig().to_json()) == Config()
    for name in ("input_condition_mask", "learned_variance"):
        assert getattr(Config().model, name) == getattr(JConfig().model, name) is False


# the four blocks no UNet builds: (name, JAX module, port module, input shape, call kwargs)
def _blocks():
    from founddiff_tpu.models import blocks as jb
    from founddiff_tpu_torch.models import blocks as tb

    return {
        "cross_context": (jb.CrossAttention(query_dim=32), tb.CrossAttention(32),
                          (2, 4, 6, 32), True),
        # self-attention at Lq * Lk = 1024^2, Lk >= 128: the flash route on both sides
        "cross_self_flash": (jb.CrossAttention(query_dim=32), tb.CrossAttention(32, 32),
                             (1, 32, 32, 32), False),
        "channel_attention": (jb.ChannelAttention(num_feat=32, squeeze_factor=8),
                              tb.ChannelAttention(32, 8), (2, 5, 7, 32), False),
        "timestep_embedder": (jb.TimestepEmbedder(hidden_size=24, frequency_embedding_size=33),
                              tb.TimestepEmbedder(24, 33), (3,), False),
    }


# the reference names each block's parameters take in the port's state dict
BLOCK_KEYS = {
    "cross_context": {"to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight",
                      "to_out.0.bias"},
    "cross_self_flash": {"to_q.weight", "to_k.weight", "to_v.weight", "to_out.0.weight",
                         "to_out.0.bias"},
    "channel_attention": {"attention.1.weight", "attention.1.bias", "attention.3.weight",
                          "attention.3.bias"},
    "timestep_embedder": {"mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias"},
}


@pytest.mark.parametrize("name", list(BLOCK_KEYS))
def test_blocks(name, monkeypatch):
    from founddiff_tpu_torch.models import blocks as tb

    jm, port, shape, with_context = _blocks()[name]
    rng = np.random.default_rng(len(name))
    if name == "timestep_embedder":
        x = np.asarray([0.0, 17.0, 603.5], np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    args = [jnp.asarray(x)]
    if with_context:
        args.append(jnp.asarray(rng.standard_normal((2, 1, 256)).astype(np.float32)))
    params = filled_params(jm, 3, *args)
    want = jit_quick(jm.apply)({"params": params}, *args)
    sd = from_jax_params(params)
    assert set(sd) == BLOCK_KEYS[name]
    port.load_state_dict(sd, strict=True)
    port.eval().requires_grad_(False)
    flash = []
    fa = tb.flash_attention
    monkeypatch.setattr(tb, "flash_attention", lambda *a: flash.append(1) or fa(*a))
    got = port(*(t_(np.asarray(a)) for a in args))
    assert got.shape == want.shape
    _close(got, want)
    assert len(flash) == (name == "cross_self_flash")
    if name == "timestep_embedder":  # cos first, a zero column at odd dim
        emb = tb.TimestepEmbedder.timestep_embedding(t_(x), 33)
        _close(emb, jm.timestep_embedding(jnp.asarray(x), 33))
        assert not emb[:, -1].any()
