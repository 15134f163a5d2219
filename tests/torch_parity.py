"""Helpers shared by the ``test_torch_*`` parity tests: seeded numpy inputs,
non-zero adaLN/prompt weights, and JAX params loaded into port modules."""

from __future__ import annotations

import jax
import numpy as np
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


# XLA's CPU backend optimisations off: the micro models below compile about
# three times faster, and run in well under a second either way
_QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                  "xla_llvm_disable_expensive_passes": True}


def jit_quick(fn, options=_QUICK_COMPILE):
    """``jax.jit(fn)`` compiled with ``options`` (by default
    :data:`_QUICK_COMPILE`), for one call."""

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
