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


def jit_quick(fn):
    """``jax.jit(fn)`` compiled with :data:`_QUICK_COMPILE`, for one call."""

    def call(*args, **kwargs):
        return jax.jit(fn).lower(*args, **kwargs).compile(_QUICK_COMPILE)(*args, **kwargs)

    return call


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
