"""The port's unified MambaBlock route (CPU, plain versions) against the JAX
package's ``ops/experimental_unified.py``.

- ``ss2d_mamba_block`` (the plain version, which follows the TPU kernel's
  arithmetic) against the JAX op (its Pallas kernels in interpret mode) and
  against ``_mamba_xla_compose``, fp32, rtol / atol 2e-5 as the JAX package's
  own test (``tests/test_ss2d_block.py``);
- the port's ``mamba_compose`` (the backward's composition) against
  ``_mamba_xla_compose``, at the same tolerance;
- gradients of x, in_proj, the depthwise conv and out_proj against
  ``jax.grad`` of the JAX op, ||g_port - g_jax|| <= 1e-4 ||g_jax||;
- the plain version against the JAX op on the grids where the CUDA front
  half's 8 x 16 pixel tiles do not divide the image and their halo lands on
  its border (4 x 4, 6 x 10, 12 x 20), with and without ``local``.
The MambaBlock on this route, and the micro models with the routes on, are
in ``tests/test_torch_routes.py``.

Inputs from numpy seeds.  The JAX weights are in JAX layouts (in_proj
[C0, 2D], taps [3, 3, 1, D], out_proj [D, C0]) and enter the port
transposed to its layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from founddiff_tpu.ops import experimental_unified as jun
from founddiff_tpu.ops.ss2d_block import _derive_weights as j_derive
from founddiff_tpu_torch.ops import experimental_unified as tun
from torch_parity import jit_quick, np_, t_

OP_TOL = 2e-5
SHAPES = [(1, 16, 16, 32, 64, 4), (2, 16, 16, 64, 128, 4)]


def _inputs(B, H, W, C0, D, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    R = -(-C0 // 16)
    return R, dict(
        x=(rng.standard_normal((B, H, W, C0)) * 0.5).astype(np.float32),
        lns=f(C0) + 1.0, lnbb=f(C0), ms=f(B, C0), mt=f(B, C0),
        inw=f(C0, 2 * D), dwk=f(3, 3, 1, D), dwb=f(D),
        xw=f(4, R + 2 * N, D), dtw=f(4, D, R),
        A=-np.abs(f(4, D, N)) - 0.5, Ds=f(4, D), bias=f(4, D),
        lng=f(D) + 1.0, lnb=f(D), loc=f(B, D), pw=f(D, C0), gate=f(B, C0),
    )


def _jax_op(i, D, R, N, local, **over):
    a = {k: jnp.asarray(v) for k, v in i.items()}
    a.update(over)
    return jun.ss2d_mamba_block(
        a["x"], a["lns"], a["lnbb"], a["ms"], a["mt"], in_proj_w=a["inw"], dw_kernel=a["dwk"],
        dw_bias=a["dwb"], x_proj_weight=a["xw"], dt_projs_weight=a["dtw"], A=a["A"],
        Dskip=a["Ds"], delta_bias=a["bias"], out_ln_g=a["lng"], out_ln_b=a["lnb"],
        local=a["loc"] if local else None, proj_w=a["pw"], gate=a["gate"], d_inner=D,
        dt_rank=R, d_state=N)


def _jax_op_jit(i, D, R, N, local, **over):
    """:func:`_jax_op` compiled once (the interpret-mode kernels run several
    times faster compiled than op by op)."""
    return jit_quick(lambda a: _jax_op(a, D, R, N, local, **over))(
        {k: jnp.asarray(v) for k, v in i.items()})


def _port_op(fn, i, D, R, N, local, **over):
    """``fn`` (the port's op or its plain version) on the inputs, weights
    transposed to the port's layouts."""
    a = {k: t_(v) for k, v in i.items()}
    a.update(over)
    return fn(a["x"], a["lns"], a["lnbb"], a["ms"], a["mt"], in_proj_w=a["inw"].t(),
              dw_kernel=a["dwk"].permute(3, 2, 0, 1), dw_bias=a["dwb"],
              x_proj_weight=a["xw"], dt_projs_weight=a["dtw"], A=a["A"], Dskip=a["Ds"],
              delta_bias=a["bias"], out_ln_g=a["lng"], out_ln_b=a["lnb"],
              local=a["loc"] if local else None, proj_w=a["pw"].t(), gate=a["gate"],
              d_inner=D, dt_rank=R, d_state=N)


def _jax_compose_args(i, D, R, N):
    a = {k: jnp.asarray(v) for k, v in i.items()}
    wd, wb, wc = j_derive(a["xw"], a["dtw"], R, N)
    geff = a["lns"][None] * (1.0 + a["ms"])
    beff = a["lnbb"][None] * (1.0 + a["ms"]) + a["mt"]
    return (a["x"], geff, beff, a["inw"][:, :D], a["inw"][:, D:],
            a["dwk"][:, :, 0, :].reshape(9, D), a["dwb"].reshape(1, D), wd, wb, wc, a["A"],
            a["Ds"], a["bias"], a["lng"], a["lnb"], a["loc"], a["pw"], a["gate"])


def _jax_compose(i, D, R, N, local):
    """``_mamba_xla_compose`` on the inputs, compiled once."""
    return jit_quick(lambda *a: jun._mamba_xla_compose(*a, True, local, True, 1e-5, 1e-5))(
        *_jax_compose_args(i, D, R, N))


def _close(got, want, rtol=OP_TOL, atol=OP_TOL):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,H,W,C0,D,N,local", [(*SHAPES[0], True), (*SHAPES[0], False),
                                                  (*SHAPES[1], True)])
def test_mamba_block_op(B, H, W, C0, D, N, local):
    R, i = _inputs(B, H, W, C0, D, N, seed=C0 + B)
    before = tun.ss2d_mamba_block.launches
    got = _port_op(tun.ss2d_mamba_block, i, D, R, N, local)
    _close(got, _jax_op_jit(i, D, R, N, local))  # Pallas, interpret mode
    _close(got, _jax_compose(i, D, R, N, local))
    _close(_port_op(tun.ss2d_mamba_block_plain, i, D, R, N, local), got, 0, 0)
    assert tun.ss2d_mamba_block.launches == before  # CPU never launches


@pytest.mark.parametrize("B,H,W,C0,D,N,local", [(2, 4, 4, 32, 64, 4, True),
                                                  (1, 6, 10, 32, 64, 8, False),
                                                  (1, 12, 20, 32, 64, 4, True),
                                                  (2, 12, 20, 64, 128, 4, False)])
def test_mamba_block_op_edge_grids(B, H, W, C0, D, N, local):
    R, i = _inputs(B, H, W, C0, D, N, seed=H * W + C0)
    got = _port_op(tun.ss2d_mamba_block_plain, i, D, R, N, local)
    assert got.shape == (B, H, W, C0)
    _close(got, _jax_op_jit(i, D, R, N, local))  # Pallas, interpret mode


@pytest.mark.parametrize("local", [True, False])
def test_mamba_compose(local):
    B, H, W, C0, D, N = SHAPES[1]
    R, i = _inputs(B, H, W, C0, D, N, seed=3)
    args = _jax_compose_args(i, D, R, N)
    want = _jax_compose(i, D, R, N, local)
    t = [t_(np.asarray(a)) for a in args]
    t[6] = t[6].reshape(D)
    t[15] = t[15] if local else None
    got = tun.mamba_compose(*t, 1e-5, 1e-5)
    _close(got, want)


def test_mamba_block_op_no_dw_bias():
    B, H, W, C0, D, N = SHAPES[0]
    R, i = _inputs(B, H, W, C0, D, N, seed=5)
    want = _jax_op_jit(i, D, R, N, True, dwb=None)
    _close(_port_op(tun.ss2d_mamba_block, i, D, R, N, True, dwb=None), want)


def test_mamba_block_op_gradients():
    B, H, W, C0, D, N = SHAPES[0]
    R, i = _inputs(B, H, W, C0, D, N, seed=11)
    w = np.random.default_rng(12).standard_normal((B, H, W, C0)).astype(np.float32)

    def loss(x, inw, dwk, pw):
        return jnp.sum(_jax_op(i, D, R, N, True, x=x, inw=inw, dwk=dwk, pw=pw) * w)

    want = jit_quick(jax.grad(loss, argnums=(0, 1, 2, 3)))(*(jnp.asarray(i[k])
                                                  for k in ("x", "inw", "dwk", "pw")))
    x, inw, dwk, pw = (t_(i[k]).requires_grad_(True) for k in ("x", "inw", "dwk", "pw"))
    out = _port_op(tun.ss2d_mamba_block, i, D, R, N, True, x=x, inw=inw, dwk=dwk, pw=pw)
    (out * t_(w)).sum().backward()
    for name, g, ref in zip(("x", "in_proj", "dwconv", "out_proj"),
                            (x.grad, inw.grad, dwk.grad, pw.grad), want):
        ref = np.asarray(ref)
        err = np.linalg.norm(np_(g) - ref)
        assert err <= 1e-4 * np.linalg.norm(ref), (name, err, np.linalg.norm(ref))
