"""Helpers shared by the ``test_torch_*`` parity tests: seeded numpy inputs,
non-zero adaLN/prompt weights, and JAX params loaded into port modules.
JAX is imported only by the functions that call it, so that the card's
tests, which run without JAX, can use the others."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from founddiff_tpu_torch.utils.convert import from_jax_params

# the micro Dose-CLIP tower of tests/test_pipeline.py
MICRO_CLIP = (
    ("vision_layers", (1, 1, 1, 1)),
    ("vision_width", 8),
    ("embed_dim", 64),
    ("transformer_width", 32),
    ("transformer_layers", 2),
    ("transformer_heads", 4),
    ("backbone_resolution", 64),
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A module that imports this runs on one PyTorch intra-op thread: its
    tests are many small ops, and with the test workers sharing the host's
    cores PyTorch's threads contend for them, so that a 4 s test takes
    minutes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# XLA's CPU backend optimisations off: the micro models below compile about
# three times faster, and run in well under a second either way
_QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                  "xla_llvm_disable_expensive_passes": True}


def jit_quick(fn, options=_QUICK_COMPILE):
    """``jax.jit(fn)`` compiled with ``options`` (by default
    :data:`_QUICK_COMPILE`), for one call."""

    import jax

    def call(*args, **kwargs):
        return jax.jit(fn).lower(*args, **kwargs).compile(options)(*args, **kwargs)

    return call


# For programs that run longer than they compile: a train step of the micro
# VanillaUnet runs 9x slower unoptimised (its convolutions and the flash
# kernels' interpret-mode loops), so level 1 halves compile plus run.
LEVEL1_COMPILE = {"xla_backend_optimization_level": 1}


def micro_vanilla_params(model, seed: int):
    """A JAX ``VanillaUnet``'s param tree from its shapes (``eval_shape``,
    which compiles nothing), filled from ``numpy.random.default_rng(seed)``:
    kernels U(+-fan_in^-0.5) as the torch init draws them, every other leaf
    its init value (1 for norm scales and ``g``, 0 for biases) plus
    N(0, 0.1), so that no affine is the identity."""
    import jax.numpy as jnp

    return filled_params(model, seed, jnp.zeros((1, 16, 16, model.channels)), jnp.zeros((1,)))


def filled_params(model, seed: int, *args, **kwargs):
    """``model``'s param tree for a call on ``args`` from its shapes
    (``eval_shape``, which compiles nothing), filled as
    :func:`micro_vanilla_params` fills it."""
    import jax

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args, **kwargs)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = float(np.prod(s.shape[:-1])) ** -0.5
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        base = 1.0 if leaf in ("scale", "g") else 0.0
        return (base + rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def perturb(params, seed: int, std: float = 0.02):
    """Copy of a JAX param tree with every ``adaLN`` and ``prompt`` leaf
    replaced by N(0, std) from ``numpy.random.default_rng(seed)``: the
    zero-initialised adaLN would make every MambaBlock the identity and hide
    a wrong block."""
    rng = np.random.default_rng(seed)

    def walk(tree, hot):
        out = {}
        for k, v in tree.items():
            h = hot or k in ("adaLN", "prompt")
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(dict(v), h)
            elif h:
                out[k] = (rng.standard_normal(np.shape(v)) * std).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(dict(params), False)


def load_port(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    """Load a JAX param tree into a port module (strict: every key)."""
    module.load_state_dict(from_jax_params(jax_params), strict=True)
    return module.eval().requires_grad_(False)


def np_(x) -> np.ndarray:
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x,
                      dtype=np.float32)


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def check_param_grads(model: torch.nn.Module, want) -> None:
    """Every parameter's gradient against ``want`` (the JAX gradient tree
    through ``from_jax_params``): ||g - w|| <= 1e-3 ||w|| + 1e-6 each."""
    checked = 0
    for name, p in model.named_parameters():
        g, w = p.grad, want[name]
        assert g is not None, name
        err = float((g - w).norm())
        assert err <= 1e-3 * float(w.norm()) + 1e-6, (name, err, float(w.norm()))
        checked += 1
    assert checked == len(want)


def set_bn_stats(model, slices: torch.Tensor) -> None:
    """Each batch-norm's running statistics of the ``CLIPIQA`` ``model`` set
    to those of its input in one image-tower pass over ``slices`` ([N, H, W,
    1] in [0, 1], without autograd): a trained tower's statistics are those
    of its data."""
    from founddiff_tpu_torch.models.clip import FrozenBatchNorm

    def set_stats(bn, args):
        flat = args[0].reshape(-1, args[0].shape[-1]).double()
        bn.running_mean.copy_(flat.mean(0))
        bn.running_var.copy_(flat.var(0))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model.clip_model.encode_image((slices * 2 - 1).repeat_interleave(3, dim=-1))
    finally:
        for h in hooks:
            h.remove()


def calibrated_micro_clipiqa(seed: int, slices: np.ndarray, size: int):
    """The port's seeded micro Dose-CLIP tower (``MICRO_CLIP``) with each
    batch-norm's statistics set to those of its input over ``slices``
    ([N, H, W, 1] in [0, 1]), and the same weights as a JAX ``CLIPIQA``
    tree (the JAX converter's).  At the seeded statistics the tower gives
    nearly the same features for every image (their spread is about 1e-4 of
    their size), which leaves the distances between them to rounding."""
    import jax
    import jax.numpy as jnp

    from founddiff_tpu.models.clip import CLIPIQA as JCLIPIQA
    from founddiff_tpu.utils.torch_convert import Converter, _apply, convert_clipiqa
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.clip import CLIPIQA

    model = CLIPIQA(**dict(MICRO_CLIP))
    init_params(model, torch.Generator().manual_seed(seed))
    set_bn_stats(model, torch.from_numpy(np.asarray(slices, np.float32)))
    jm = JCLIPIQA(**dict(MICRO_CLIP))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes["params"])
    c = Converter({"m." + k: v.numpy() for k, v in model.state_dict().items()})
    convert_clipiqa(c, "", "m", vision_layers=(1, 1, 1, 1), transformer_layers=2)
    assert c.missing == []
    params, _ = _apply(template, {tuple(p for p in k if p): v for k, v in c.out.items()})
    return model.eval(), jm, params
