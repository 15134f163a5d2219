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

import founddiff_tpu.ops.scan_pallas as jsp
from founddiff_tpu.models import blocks as jblocks
from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu_torch.models import blocks as tblocks
from founddiff_tpu_torch.models import ss2d as tss2d
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import check_param_grads, jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# the grids the fused SS2D block does not take: odd (the unfused route) and
# even with a side of 2 (the epilogue route)
ROUTE_GRIDS = [(5, 5), (3, 7), (2, 2), (2, 6)]


@pytest.mark.parametrize("C,impl,H,W", [
    pytest.param(C, impl, 8, 8, id=f"{C}-{impl}")
    for C, impl in [(32, "chunked"), (32, "pallas_fused"), (128, "chunked"),
                    (128, "pallas_fused")]
] + [pytest.param(32, "pallas_fused", H, W, id=f"32-pallas_fused-{H}x{W}")
     for H, W in ROUTE_GRIDS])
def test_mamba_block(C, impl, H, W):
    """C=32 runs norm2 + plain attention, C=128 the fused attention half;
    ``pallas_fused`` is the JAX package's TPU routing (interpret mode).  The
    8x8 grid takes the fused SS2D block, the others the unfused or the
    epilogue route."""
    jm, params, x, c, t = _mamba(C, impl, H, W)
    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    tm = load_port(tss2d.MambaBlock(C, 4, time_dim=64), params)
    got = tm(t_(x), t_(c), t_(t))
    _close(got, want)
    assert not np.allclose(np_(got), x, atol=1e-3)  # the gates are live


def _mamba(C, impl, H, W):
    B, N, tdim = 2, 4, 64
    x, c, t = _rand(1, B, H, W, C), _rand(2, B, 1, 256, scale=0.1), _rand(3, B, tdim)
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, scan_impl=impl)
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(0), x, c, t)["params"], seed=C)
    return jm, params, x, c, t


@pytest.mark.parametrize("H,W,joint", [(H, W, False) for H, W in ROUTE_GRIDS] + [(2, 2, True)])
def test_mamba_block_gradients(H, W, joint, monkeypatch):
    """d(sum(out * w))/d(x, every parameter) on the unfused and epilogue
    routes against jax.grad of the JAX block (``pallas_fused``); per
    parameter ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-6.  ``joint``: the
    epilogue route's other scan, the decimated fused-projection scan and
    the joint layout, which both packages take where
    ``image_scan_vmem_ok`` fails."""
    if joint:
        monkeypatch.setattr(jsp, "image_scan_vmem_ok", lambda *a: False)
        monkeypatch.setattr(tss2d, "image_scan_vmem_ok", lambda *a: False)
    jm, params, x, c, t = _mamba(32, "pallas_fused", H, W)
    w = _rand(4, *x.shape)

    def loss(p, x_):
        return jnp.sum(jm.apply({"params": p}, x_, *map(jnp.asarray, (c, t))) * w)

    g_params, g_x = jit_quick(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tm = load_port(tss2d.MambaBlock(32, 4, time_dim=64), params).requires_grad_(True)
    xt = t_(x).requires_grad_(True)
    (tm(xt, t_(c), t_(t)) * t_(w)).sum().backward()
    _close(xt.grad, g_x)
    check_param_grads(tm, from_jax_params(g_params))


def test_resnet_block_with_skip():
    x, skip = _rand(4, 2, 8, 8, 16), _rand(5, 2, 8, 8, 8)
    jm = jblocks.ResnetBlock(16, groups=8)
    params = jm.init(jax.random.PRNGKey(1), x, skip=skip)["params"]
    want = jm.apply({"params": params}, jnp.asarray(x), skip=jnp.asarray(skip))
    tm = load_port(tblocks.ResnetBlock(24, 16, groups=8), params)
    _close(tm(t_(x), skip=t_(skip)), want)
