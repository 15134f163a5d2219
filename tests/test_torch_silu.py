"""``FOUNDDIFF_SILU=kernel`` in the port: the silu of the SS2D scan input
inside the fused block (``ss2d_image_block(..., silu_input=True)``), on the
CPU against the JAX package.

- one ``MambaBlock`` (C 32, an 8x12 grid: the fused-block route) under the
  variable, against one JAX ``MambaBlock`` with ``scan_impl="pallas_fused"``
  under it (interpret mode), as ``tests/test_torch_routes.py`` builds the
  unified case: both sides are seen passing ``silu_input=True``; the
  forward, and d(sum(out * w))/d(x, every parameter) in fp32 (the JAX remat
  backward computes the silu in the input dtype, so bf16 gradients are not
  compared);
- the variable is read at each call, and only on the fused-block route:
  unset, the same block passes ``silu_input=False`` and gives the same
  output within fp32 rounding; on an odd grid it changes nothing;
- the plain version with ``silu_input`` is the plain version of the
  io-rounded silu of its input, bit for bit, in fp32 and bf16.

fp32; rtol 1e-3 / atol 1e-4; gradients ||g - w|| <= 1e-3 ||w|| + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu.ops import ss2d_block as jblock
from founddiff_tpu_torch.models import ss2d as tss2d
from founddiff_tpu_torch.ops import ss2d_block as tblock
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import check_param_grads, jit_quick, load_port, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
C, N, TDIM = 32, 4, 64


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _record(monkeypatch, module, seen, key):
    fn = module.ss2d_image_block

    def wrapped(*a, **k):
        seen.setdefault(key, []).append(k.get("silu_input", False))
        return fn(*a, **k)

    monkeypatch.setattr(module, "ss2d_image_block", wrapped)


def _inputs(H, W, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    c = (rng.standard_normal((2, 1, 256)) * 0.1).astype(np.float32)
    t = rng.standard_normal((2, TDIM)).astype(np.float32)
    w = rng.standard_normal((2, H, W, C)).astype(np.float32)
    return x, c, t, w


@pytest.fixture(scope="module")
def block():
    """The JAX block and its params (adaLN perturbed), from an 8x12 init."""
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, scan_impl="pallas_fused")
    x, c, t, _ = _inputs(8, 12)
    params = jit_quick(jm.init)(jax.random.PRNGKey(0), x, c, t)["params"]
    return jm, perturb(params, seed=C)


def test_forward_and_grads_against_jax(block, monkeypatch):
    monkeypatch.setenv("FOUNDDIFF_SILU", "kernel")
    seen = {}
    _record(monkeypatch, jblock, seen, "jax")
    _record(monkeypatch, tss2d, seen, "port")
    jm, params = block
    x, c, t, w = _inputs(8, 12)

    def jloss(p, xv):
        return (jm.apply({"params": p}, xv, jnp.asarray(c), jnp.asarray(t)) * w).sum()

    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    jgrads = jit_quick(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = load_port(tss2d.MambaBlock(C, N, time_dim=TDIM), params).requires_grad_(True)
    xt = t_(x).requires_grad_(True)
    got = port(xt, t_(c), t_(t))
    _close(got, want)
    assert seen["jax"] and all(seen["jax"]) and seen["port"] == [True]
    (got * t_(w)).sum().backward()
    _close(xt.grad, jgrads[1])
    check_param_grads(port, from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads[0])))


@pytest.mark.parametrize("H,W,fused", [(8, 12, True), (5, 7, False)])
def test_the_variable_is_read_at_each_call(block, monkeypatch, H, W, fused):
    seen = {}
    _record(monkeypatch, tss2d, seen, "port")
    port = load_port(tss2d.MambaBlock(C, N, time_dim=TDIM), block[1])
    x, c, t, _ = _inputs(H, W, seed=4)
    outs = {}
    for value in ("kernel", "xla", None):
        if value is None:
            monkeypatch.delenv("FOUNDDIFF_SILU", raising=False)
        else:
            monkeypatch.setenv("FOUNDDIFF_SILU", value)
        outs[value] = port(t_(x), t_(c), t_(t))
    assert seen.get("port", []) == ([True, False, False] if fused else [])
    torch.testing.assert_close(outs["kernel"], outs[None], rtol=1e-5, atol=1e-5)
    assert torch.equal(outs["xla"], outs[None])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_applies_the_rounded_silu(dtype):
    rng = np.random.default_rng(9)
    B, H, W, C0, D, R = 2, 4, 6, 8, 16, 1
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    x1, xr = f(B, H, W, C0).to(dtype), f(B, H, W, C0).to(dtype)
    raw = f(B, H, W, D).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
    weights = dict(w_z=f(C0, D, scale=0.3), x_proj_weight=f(4, R + 2 * N, D, scale=0.3),
                   dt_projs_weight=f(4, D, R, scale=0.5), A=A, Dskip=torch.ones(4, D),
                   delta_bias=f(4, D, scale=0.1) - 3.0, ln_g=f(D, scale=0.1) + 1,
                   ln_b=f(D, scale=0.1), local=f(B, D, scale=0.2), proj_w=f(D, C0, scale=0.3),
                   gate=f(B, C0, scale=0.3), dt_rank=R, d_state=N)
    got = tblock.ss2d_image_block(x1, raw, xr, silu_input=True, **weights)
    want = tblock.ss2d_image_block(x1, torch.nn.functional.silu(raw.float()).to(dtype), xr,
                                   **weights)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(got, tblock.ss2d_image_block_plain(x1, raw, xr, silu_input=True,
                                                          **weights))
