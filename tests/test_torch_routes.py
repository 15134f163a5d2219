"""The two opt-in routes, ``FOUNDDIFF_GN=pallas`` and ``FOUNDDIFF_UNIFIED=1``,
through the port's models (CPU, plain versions) against the JAX package.

- one ``MambaBlock`` of each attention half (C 32 and 128) with
  ``FOUNDDIFF_UNIFIED=1``, against one JAX ``MambaBlock`` with
  ``scan_impl="pallas_fused"`` under the same variable (interpret mode), so
  that the JAX routing conditions themselves choose the unified op; both
  sides are seen calling it;
- the micro FoundDiff UNet of ``tests/test_torch_slice.py`` (dim 32, mults
  (1, 4), 16^2) with both variables set, against the JAX UNet under the same
  variables (its GroupNorm pair in interpret mode; its ``chunked`` CPU scan
  routes the MambaBlocks as the port's unified op computes them);
- the micro ``VanillaUnet`` (dim 8, mults (1, 2), 16^2) with
  ``FOUNDDIFF_GN=pallas`` against the JAX one under the same variable;
- one micro train-step loss of the FoundDiff UNet and every parameter's
  gradient, routes on against routes off, in the port.

Weights: converted JAX params loaded strictly (``from_jax_params``), so the
routed models read exactly the parameters that exist.  Inputs from numpy
seeds; fp32; rtol 1e-3 / atol 1e-4 as the other model tests of the port;
gradients per parameter ||g_on - g_off|| <= 1e-3 ||g_off|| + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.models.vanilla_unet import VanillaUnet as JVanillaUnet
from founddiff_tpu.ops import experimental_unified as jun
from founddiff_tpu.utils.torch_convert import convert_denoiser_params
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.models import ss2d as tss2d
from founddiff_tpu_torch.models.vanilla_unet import VanillaUnet
from founddiff_tpu_torch.ops import groupnorm as tgn
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import (MICRO_CLIP, jit_quick, load_port, micro_vanilla_params, np_, perturb,
                          t_)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
DIM, MULTS, SIZE = 32, (1, 4), 16


def _routes(monkeypatch, gn: bool, unified: bool):
    for name, on, value in (("FOUNDDIFF_GN", gn, "pallas"), ("FOUNDDIFF_UNIFIED", unified, "1")):
        if on:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _count_calls(monkeypatch, module, name, calls, key):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("C", [32, 128])
def test_mamba_block_on_the_unified_route(C, monkeypatch):
    _routes(monkeypatch, gn=False, unified=True)
    B, H, W, N, tdim = 2, 8, 12, 4, 64
    rng = np.random.default_rng(C)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    c = (rng.standard_normal((B, 1, 256)) * 0.1).astype(np.float32)
    t = rng.standard_normal((B, tdim)).astype(np.float32)
    calls = {}
    _count_calls(monkeypatch, jun, "ss2d_mamba_block", calls, "jax")
    _count_calls(monkeypatch, tss2d, "ss2d_mamba_block", calls, "port")
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, scan_impl="pallas_fused")
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(0), x, c, t)["params"], seed=C)
    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    port = load_port(tss2d.MambaBlock(C, N, time_dim=tdim), params)
    got = port(t_(x), t_(c), t_(t))
    assert calls["jax"] >= 1 and calls["port"] == 1
    _close(got, want)
    assert not np.allclose(np_(got), x, atol=1e-3)  # the gates are live


def _micro_config():
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.diffusion.image_size = SIZE
    return cfg


@pytest.fixture(scope="module")
def micro_founddiff():
    """The micro JAX model and its params: the port's seeded init carried into
    the JAX tree by the JAX converter (the tree's shapes from ``eval_shape``,
    which compiles nothing), adaLN and prompt perturbed."""
    jm = JFoundDiff(dim=DIM, dim_mults=MULTS, scan_impl="chunked", clip_overrides=MICRO_CLIP)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(4), x0, time0)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, model = build(_micro_config(), device="cpu", seed=4, clip_overrides=MICRO_CLIP)
    state = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    params, _, missing = convert_denoiser_params(
        state, template, num_res=len(MULTS), clip_vision_layers=(1, 1, 1, 1),
        clip_transformer_layers=2)
    assert missing == []
    return jm, perturb(params, seed=4)


def _port_founddiff(params, train=False):
    diffusion, model = build(_micro_config(), device="cpu", clip_overrides=MICRO_CLIP,
                             train=train)
    model.load_state_dict(from_jax_params(params), strict=True)
    return diffusion, model


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, SIZE, SIZE, 2)).astype(np.float32)
    time = [rng.random(2).astype(np.float32) * 300, rng.random(2).astype(np.float32) * 30]
    dose = rng.standard_normal((2, 64)).astype(np.float32)
    content = (rng.standard_normal((2, 1, 256)) * 0.1).astype(np.float32)
    return x, time, dose, content


def test_micro_founddiff_with_both_routes(micro_founddiff, monkeypatch):
    _routes(monkeypatch, gn=True, unified=True)
    calls = {}
    _count_calls(monkeypatch, tss2d, "ss2d_mamba_block", calls, "unified")
    _count_calls(monkeypatch, tgn, "gn_apply", calls, "gn_apply")
    jm, params = micro_founddiff
    model = _port_founddiff(params)[1].eval()
    x, time, dose, content = _unet_inputs(12)
    want = jit_quick(lambda p, *a, **k: jm.apply({"params": p}, *a, **k))(
        params, jnp.asarray(x), [jnp.asarray(t) for t in time],
        dose_embedding=jnp.asarray(dose), content_embedding=jnp.asarray(content))
    got = model(t_(x), [t_(t) for t in time], dose_embedding=t_(dose),
                content_embedding=t_(content))
    _close(got[0], want[0])
    # 5 MambaBlocks and 6 ResnetBlocks in the micro UNet, each on its route
    assert calls == {"unified": 5, "gn_apply": 6}


def test_micro_vanilla_unet_with_the_gn_route(monkeypatch):
    _routes(monkeypatch, gn=True, unified=False)
    calls = {}
    _count_calls(monkeypatch, tgn, "gn_apply", calls, "gn_apply")
    jm = JVanillaUnet(dim=8, dim_mults=(1, 2), channels=1)
    params = micro_vanilla_params(jm, seed=5)
    model = load_port(VanillaUnet(8, (1, 2), channels=1), params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    t = np.asarray([17.0, 803.0], np.float32)
    want = jit_quick(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    _close(model(t_(x), t_(t)), want)
    assert calls == {"gn_apply": 2 * 11}  # two Blocks in each of 11 TimeResnetBlocks


def test_micro_train_step_routes_on_and_off(micro_founddiff, monkeypatch):
    """One microbatch's loss and gradients, with t and the noise handed in:
    the routes change where the arithmetic runs, not what it computes."""
    params = micro_founddiff[1]
    rng = np.random.default_rng(7)
    imgs = [t_(rng.random((2, SIZE, SIZE, 1)).astype(np.float32)) for _ in range(2)]
    t = torch.tensor([123, 876])
    noise = t_(rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32))
    results = {}
    for on in (False, True):
        _routes(monkeypatch, gn=on, unified=on)
        diffusion, model = _port_founddiff(params, train=True)
        loss = sum(diffusion.loss(imgs, t=t, noise=noise))
        loss.backward()
        results[on] = (loss.item(), {n: p.grad for n, p in model.named_parameters()
                                     if p.requires_grad})
    (l_off, g_off), (l_on, g_on) = results[False], results[True]
    assert l_on == pytest.approx(l_off, rel=1e-5)
    assert set(g_on) == set(g_off) and len(g_on) > 100
    for name, g in g_off.items():
        assert g_on[name] is not None, name
        err = float((g_on[name] - g).norm())
        assert err <= 1e-3 * float(g.norm()) + 1e-6, (name, err, float(g.norm()))
