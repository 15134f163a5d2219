"""Port blocks (CPU) against the JAX package's modules at shared weights.

Weights come from the JAX module's init, with adaLN and prompt overwritten
by seeded N(0, 0.02) so that every MambaBlock gate is non-zero, and enter
the port through ``from_jax_params`` (strict).  fp32 on both sides;
rtol 1e-3 / atol 1e-4 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from founddiff_tpu.models import blocks as jblocks
from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu_torch.models import blocks as tblocks
from founddiff_tpu_torch.models import ss2d as tss2d
from torch_parity import jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("C,impl", [(32, "chunked"), (32, "pallas_fused"),
                                    (128, "chunked"), (128, "pallas_fused")])
def test_mamba_block(C, impl):
    """C=32 runs norm2 + plain attention, C=128 the fused attention half;
    ``pallas_fused`` is the JAX package's TPU routing (interpret mode)."""
    B, H, W, N, tdim = 2, 8, 8, 4, 64
    x, c, t = _rand(1, B, H, W, C), _rand(2, B, 1, 256, scale=0.1), _rand(3, B, tdim)
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, scan_impl=impl)
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(0), x, c, t)["params"], seed=C)
    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    tm = load_port(tss2d.MambaBlock(C, N, time_dim=tdim), params)
    got = tm(t_(x), t_(c), t_(t))
    _close(got, want)
    assert not np.allclose(np_(got), x, atol=1e-3)  # the gates are live


def test_resnet_block_with_skip():
    x, skip = _rand(4, 2, 8, 8, 16), _rand(5, 2, 8, 8, 8)
    jm = jblocks.ResnetBlock(16, groups=8)
    params = jm.init(jax.random.PRNGKey(1), x, skip=skip)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), skip=jnp.asarray(skip))
    tm = load_port(tblocks.ResnetBlock(24, 16, groups=8), params)
    _close(tm(t_(x), skip=t_(skip)), want)
