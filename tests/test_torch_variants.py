"""UNet variants of the port against the JAX package at shared weights: two
UNets (``num_unet=2``, ``test_res_or_noise="res_noise"``), ``self_condition``
and ``input_condition``, each a micro conditioned ``UnetRes`` (dim 8 x (1,
2), 16^2, batch 2).  JAX runs its ``chunked`` CPU route, the port its TPU
routing through the plain versions; the JAX params come from ``eval_shape``
filled with numpy (``filled_params``).  fp32; rtol 1e-3 / atol
1e-4, as the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from founddiff_tpu.models.unet import UnetRes as JUnetRes
from founddiff_tpu_torch.models.unet import UnetRes
from torch_parity import jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4

VARIANTS = {
    "two_unets": dict(num_unet=2, objective="pred_res_noise", test_res_or_noise="res_noise"),
    "self_condition": dict(self_condition=True, objective="pred_res"),
    "input_condition": dict(input_condition=True, objective="pred_res"),
}


def filled_params(model, seed: int, *args, **kwargs):
    """A JAX module's param tree from ``eval_shape`` of its init on
    ``args``/``kwargs`` (nothing compiles), filled from
    ``numpy.random.default_rng(seed)`` as ``torch_parity.micro_vanilla_params``
    fills it, then ``perturb``'s adaLN and prompt."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = float(np.prod(s.shape[:-1])) ** -0.5
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        base = 1.0 if leaf in ("scale", "g") else 0.0
        return (base + rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return perturb(jax.tree_util.tree_map_with_path(fill, shapes), seed)


def micro_variant(kw, seed):
    """The JAX micro UnetRes of ``kw``: its filled params, its output and
    the inputs ``(x, time, x_self_cond)``."""
    jm = JUnetRes(dim=8, dim_mults=(1, 2), condition=True, scan_impl="chunked", **kw)
    rng = np.random.default_rng(seed)
    ch = 2 + int(kw.get("input_condition", False))
    x = rng.standard_normal((2, 16, 16, ch)).astype(np.float32)
    time = [rng.random(2).astype(np.float32) * 300, rng.random(2).astype(np.float32) * 30]
    sc = rng.standard_normal((2, 16, 16, 1)).astype(np.float32) \
        if kw.get("self_condition") else None
    jt = [jnp.asarray(t) for t in time]
    jsc = None if sc is None else jnp.asarray(sc)
    params = filled_params(jm, seed, jnp.asarray(x), jt, x_self_cond=jsc)
    out = jit_quick(lambda p, v, t, s: jm.apply({"params": p}, v, t, x_self_cond=s))(
        params, jnp.asarray(x), jt, jsc)
    return params, out, (x, time, sc)


def close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_unet_variant(name):
    kw = VARIANTS[name]
    params, want, (x, time, sc) = micro_variant(kw, seed=len(name))
    port = load_port(UnetRes(8, (1, 2), condition=True, **kw), params)
    got = port(t_(x), [t_(t) for t in time], x_self_cond=None if sc is None else t_(sc))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w)
