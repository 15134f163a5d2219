"""Any ``d_state``: the identities the CUDA wrappers rest on, and a UNet whose
state sizes are no power of two, on the CPU.

- Padding: a state padded with zero B and C and A = -1 starts at 0, stays 0
  and adds nothing to y, so ``scan_forward_plain``/``scan_backward_plain``
  on operands padded from N = 6 and 12 to 8 and 16 give the unpadded y,
  h_bounds and the seven gradients (the padded states' own entries sliced
  off), within 1e-6 of each output's largest magnitude.
- Groups: N = 128 as two groups of 64, y summed in fp32 with Dskip u added
  once, gu and gdelta summed, gA/gB/gC/h_bounds concatenated, within the
  same bound (only the order of the sums over n moves).
- The bounds-only forward gives the full forward's h_bounds.
- A micro UNet built with ``base_d_state`` 3 (the JAX ``Unet`` field,
  ``founddiff_tpu/models/unet.py:57``), so N = 3, 6 and 12 at its three
  levels, at shared weights against JAX (its ``chunked`` scan; the port's
  plain versions), rtol 1e-3 / atol 1e-4 as the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models.unet import Unet as JUnet
from founddiff_tpu_torch.models.unet import UnetRes
from founddiff_tpu_torch.ops import scan as tscan
from torch_parity import jit_quick, load_port, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

IDENT = 1e-6


def _operands(N, B=2, K=4, L=45, D=24, seed=0):
    rs = np.random.RandomState(seed + N)
    f = lambda *s, sc=0.5: t_(rs.randn(*s) * sc)
    return dict(u=f(B, K, L, D, sc=1.0), delta=f(B, K, L, D), A=-t_(rs.rand(K, D, N) * 2 + 0.2),
                B=f(B, K, L, N), C=f(B, K, L, N), Ds=f(K, D), bias=f(K, D) - 1.0,
                dy=f(B, K, L, D, sc=1.0))


def _run(o, A, Bm, Cm, Ds, chunk):
    y, hb = tscan.scan_forward_plain(o["u"], o["delta"], A, Bm, Cm, Ds, o["bias"], chunk)
    grads = tscan.scan_backward_plain(o["u"], o["delta"], A, Bm, Cm, Ds, o["bias"], hb,
                                      o["dy"], chunk)
    return y, hb, grads


def _same(got, want):
    """Within 1e-6 of the output's largest magnitude: the same sums in
    another order (fp32 keeps about 7 digits)."""
    w = np_(want)
    np.testing.assert_allclose(np_(got), w, rtol=0, atol=IDENT * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("N,Np", [(6, 8), (12, 16)])
def test_padded_states_change_nothing(N, Np):
    o = _operands(N)
    chunk = tscan.scan_chunk(N)
    y, hb, g = _run(o, o["A"], o["B"], o["C"], o["Ds"], chunk)
    A, Bm, Cm = tscan.pad_states(o["A"], o["B"], o["C"])
    assert A.shape[-1] == Bm.shape[-1] == Np and tscan.kernel_states(N) == Np
    yp, hbp, gp = _run(o, A, Bm, Cm, o["Ds"], chunk)
    _same(yp, y)
    _same(hbp[:, :, :N], hb)
    assert not hbp[:, :, N:].any()  # the padded states stay 0
    gu, gd, gA, gB, gC, gDs, gbias = gp
    for got, want in zip((gu, gd, gA[..., :N], gB[..., :N], gC[..., :N], gDs, gbias), g):
        _same(got, want)


def test_grouped_states_sum_in_fp32():
    N, G = 128, 64
    o = _operands(N, L=37, D=16)
    chunk = tscan.scan_chunk(N)
    y, hb, g = _run(o, o["A"], o["B"], o["C"], o["Ds"], chunk)
    cut = lambda t, i: t[..., i * G:(i + 1) * G]
    # Dskip u with the first group only
    parts = [_run(o, cut(o["A"], i), cut(o["B"], i), cut(o["C"], i),
                  o["Ds"] if i == 0 else torch.zeros_like(o["Ds"]), chunk) for i in range(2)]
    (y0, hb0, g0), (y1, hb1, g1) = parts
    _same(y0.float() + y1.float(), y)
    _same(torch.cat([hb0, hb1], dim=2), hb)
    gu, gd, gA, gB, gC, gDs, gbias = g
    _same(g0[0] + g1[0], gu)
    _same(g0[1] + g1[1], gd)
    for i, cat_of in ((2, gA), (3, gB), (4, gC)):
        _same(torch.cat([g0[i], g1[i]], dim=-1), cat_of)
    _same(g0[5], gDs)  # dy * u: no state in it
    _same(g0[6] + g1[6], gbias)


@pytest.mark.parametrize("N", [3, 12])
def test_bounds_only_forward(N):
    o = _operands(N)
    args = (o["u"], o["delta"], o["A"], o["B"], o["C"], o["Ds"], o["bias"])
    y, hb = tscan.scan_forward(*args)
    none, hb_only = tscan.scan_forward(*args, bounds_only=True)
    assert none is None and y is not None
    assert torch.equal(hb_only, hb)


def test_unet_base_d_state_3():
    """N = 3, 6, 12 at the three levels of a micro UNet (dim 8 x (1, 2, 4) at
    32^2: the fused block at 32^2 and 16^2, the 8^2 level and mid too)."""
    mults = (1, 2, 4)
    jm = JUnet(dim=8, dim_mults=mults, condition=True, base_d_state=3, scan_impl="chunked")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 32, 2)).astype(np.float32)
    time = [np.array([250.0], np.float32), np.array([20.0], np.float32)]
    init = jit_quick(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(time[0]))
    params = perturb(init["params"], seed=3)
    want = jit_quick(lambda p, v, t: jm.apply({"params": p}, v, t))(
        params, jnp.asarray(x), jnp.asarray(time[0]))
    port = load_port(UnetRes(8, mults, objective="pred_res", condition=True, base_d_state=3),
                     {"unet0": params})
    states = [m.mamba.d_state for _, m, _ in port.unet0.downs]
    assert states == [3, 6, 12]
    got = port(t_(x), [t_(t) for t in time])[0]
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=1e-3, atol=1e-4)
