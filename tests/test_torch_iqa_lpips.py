"""The port's IQA helpers and LPIPS (CPU) against the JAX package.

- ``dist_to_mos`` on a seeded distribution;
- ``random_crop`` from equal ``RandomState``s, a list of two images, with and
  without the bilinear upscale of small images, bit for bit in the offsets;
- ``clip_preprocess`` of 512^2 and non-square images to 224^2 (1e-5 after the
  normalization);
- ``LPIPS`` at shared weights (rtol 1e-3 / atol 1e-4), through
  ``from_jax_params``; an ``lpips``-package state dict loading strictly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models.lpips import LPIPS as JLPIPS
from founddiff_tpu.utils import iqa as jiqa
from founddiff_tpu_torch.models import LPIPS
from founddiff_tpu_torch.utils import iqa
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import filled_params, jit_quick, np_, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def test_dist_to_mos():
    d = np.random.default_rng(0).dirichlet(np.ones(5), size=(3, 4)).astype(np.float32)
    want = np.asarray(jiqa.dist_to_mos(jnp.asarray(d)))
    got = iqa.dist_to_mos(torch.from_numpy(d))
    assert got.shape == (3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size,crop", [(48, 16), (20, 24)])
def test_random_crop(size, crop):
    rng = np.random.default_rng(1)
    a = rng.random((2, size, size + 6, 3)).astype(np.float32)
    b = rng.random((2, size, size + 6, 1)).astype(np.float32)
    want = jiqa.random_crop([jnp.asarray(a), jnp.asarray(b)], crop, 3,
                            np.random.RandomState(7))
    got = iqa.random_crop([torch.from_numpy(a), torch.from_numpy(b)], crop, 3,
                          np.random.RandomState(7))
    for g, w in zip(got, want):
        assert g.shape == (6, crop, crop, w.shape[-1])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    single = iqa.random_crop(torch.from_numpy(a), crop, 3, np.random.RandomState(7))
    assert torch.equal(single, got[0])


@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (1, 300, 200, 3), (1, 100, 180, 3)])
def test_clip_preprocess(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    want = np.asarray(jiqa.clip_preprocess(jnp.asarray(x)))
    got = iqa.clip_preprocess(torch.from_numpy(x))
    assert got.shape == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def lpips_pair():
    jm = JLPIPS()
    x = jnp.zeros((1, 64, 64, 3))
    params = filled_params(jm, 3, x, x)
    port = LPIPS()
    port.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, port.eval()


def test_lpips_against_jax(lpips_pair):
    jm, params, port = lpips_pair
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x1 = np.clip(x0 + 0.2 * rng.standard_normal(x0.shape), -1, 1).astype(np.float32)
    want = jit_quick(lambda p, a, b: jm.apply({"params": p}, a, b))(params, x0, x1)
    with torch.no_grad():
        got = port(t_(x0), t_(x1))
        same = port(t_(x0), t_(x0))
    assert got.shape == (2,)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert float(same.abs().max()) == 0.0


def test_lpips_package_state_dict_loads(lpips_pair):
    """The key set and shapes of ``lpips.LPIPS(net='alex').state_dict()``:
    the scaling buffers, the AlexNet convs at their torchvision indices in
    the five slices, the five heads."""
    want = {"scaling_layer.shift": (1, 3, 1, 1), "scaling_layer.scale": (1, 3, 1, 1)}
    convs = {"slice1.0": (64, 3, 11, 11), "slice2.3": (192, 64, 5, 5),
             "slice3.6": (384, 192, 3, 3), "slice4.8": (256, 384, 3, 3),
             "slice5.10": (256, 256, 3, 3)}
    for k, shape in convs.items():
        want[f"net.{k}.weight"] = shape
        want[f"net.{k}.bias"] = (shape[0],)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        want[f"lin{i}.model.1.weight"] = (1, c, 1, 1)
    port = lpips_pair[2]
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    gen = torch.Generator().manual_seed(5)
    sd = {k: torch.randn(s, generator=gen) for k, s in want.items()}
    fresh = LPIPS()
    fresh.load_state_dict(sd, strict=True)
    assert torch.equal(fresh.net.slice3[1].weight, sd["net.slice3.6.weight"])
