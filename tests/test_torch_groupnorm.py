"""The port's ``group_norm_silu`` (CPU) against the JAX package's, on both
routes of ``FOUNDDIFF_GN``.

Under ``FOUNDDIFF_GN=pallas`` the JAX side runs its two Pallas kernels in
interpret mode (as ``tests/test_groupnorm_pallas.py`` runs them) and the port
its ``GroupNormSiLUFn`` with ``gn_stats_plain`` and ``gn_apply_plain``; unset,
both run the plain composition.  The variable is set on both sides with
``monkeypatch``.  Cases: with and without residual, with the time
scale/shift, groups 8 and 4, batch 2, a 16x16 and a 12x10 grid; the
scale/shift also as the ``.chunk`` views of one [B, 2C] tensor (the time
MLP's output, which the kernel route reads in place).  On CPU tensors the
kernel route is ``gn_stats_plain`` (the coefficient table) then
``gn_apply_plain``; with or without a gradient to record it gives the same
bits, and the table is held against the statistics in float64.

Tolerances: fp32 rtol 1e-4 / atol 1e-5 (the same arithmetic, sums in another
order); bf16 one bf16 ulp of the output (both sides compute in fp32 and
round once, so a value on a rounding edge may round either way); gradients
of x, scale, bias, residual and the scale/shift against ``jax.grad``
through the JAX ``custom_vjp``, relative 1e-4 per gradient (||g_port -
g_jax|| <= 1e-4 ||g_jax||: the scale/shift gradients are sums over every
pixel, whose small entries differ in their last bits with the order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.ops import groupnorm_pallas as jgn
from founddiff_tpu_torch.ops import experimental_unified as tun
from founddiff_tpu_torch.ops import groupnorm as tgn
from torch_parity import np_, t_

ROUTES = ["pallas", None]
# (residual, scale_shift, groups, [B, H, W, C])
CASES = [(False, False, 8, (2, 16, 16, 16)), (True, False, 8, (2, 16, 16, 16)),
         (False, True, 4, (2, 12, 10, 16)), (True, True, 4, (2, 12, 10, 16))]


def _set_route(monkeypatch, route):
    if route is None:
        monkeypatch.delenv("FOUNDDIFF_GN", raising=False)
    else:
        monkeypatch.setenv("FOUNDDIFF_GN", route)


def _inputs(shape, res, ss, seed):
    rng = np.random.default_rng(seed)
    B, C = shape[0], shape[-1]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(*shape) * 1.5 + 0.3, scale=f(C) * 0.1 + 1, bias=f(C) * 0.1,
                residual=f(*shape) if res else None,
                scale_shift=(f(B, C) * 0.2, f(B, C) * 0.2) if ss else None)


def _call(fn, conv, i, groups):
    ss = i["scale_shift"]
    return fn(conv(i["x"]), conv(i["scale"]), conv(i["bias"]),
              residual=None if i["residual"] is None else conv(i["residual"]),
              scale_shift=None if ss is None else tuple(map(conv, ss)), groups=groups,
              eps=1e-5)


def _ulp_bf16(a):
    _, e = np.frexp(np.abs(a))
    return np.ldexp((a != 0).astype(np.float32), e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res,ss,groups,shape", CASES)
@pytest.mark.parametrize("route", ROUTES)
def test_group_norm_silu(route, res, ss, groups, shape, dtype, monkeypatch):
    _set_route(monkeypatch, route)
    i = _inputs(shape, res, ss, seed=groups + 2 * res + ss)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    before = (tgn.gn_stats.launches, tgn.gn_apply.launches)
    # x and the residual at the io dtype, the affine and the scale/shift fp32
    want = _call(jgn.group_norm_silu,
                 lambda a: jnp.asarray(a, jdt if a.shape == shape else jnp.float32), i, groups)
    got = _call(tgn.group_norm_silu,
                lambda a: t_(a).to(tdt if a.shape == shape else torch.float32), i, groups)
    assert got.dtype == tdt and want.dtype == jdt
    w, g = np.asarray(want, np.float32), np_(got)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    else:
        assert (np.abs(g - w) <= _ulp_bf16(np.maximum(np.abs(g), np.abs(w)))).all()
    assert (tgn.gn_stats.launches, tgn.gn_apply.launches) == before  # CPU never launches


@pytest.mark.parametrize("route", ROUTES)
def test_group_norm_silu_gradients(route, monkeypatch):
    _set_route(monkeypatch, route)
    shape = (2, 12, 10, 16)
    i = _inputs(shape, True, True, seed=9)
    w = np.random.default_rng(10).standard_normal(shape).astype(np.float32)
    names = ("x", "scale", "bias", "residual", "ms", "mt")
    vals = [i["x"], i["scale"], i["bias"], i["residual"], *i["scale_shift"]]

    def loss(x, scale, bias, residual, ms, mt):
        out = jgn.group_norm_silu(x, scale, bias, residual=residual, scale_shift=(ms, mt),
                                  groups=4)
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, vals))
    ts = [t_(v).requires_grad_(True) for v in vals]
    out = tgn.group_norm_silu(ts[0], ts[1], ts[2], residual=ts[3], scale_shift=(ts[4], ts[5]),
                              groups=4)
    (out * t_(w)).sum().backward()
    for name, t, ref in zip(names, ts, want):
        ref = np.asarray(ref)
        err = np.linalg.norm(np_(t.grad) - ref)
        assert err <= 1e-4 * np.linalg.norm(ref), (name, err, np.linalg.norm(ref))


def test_kernel_route_runs_the_two_kernels_plain_versions(monkeypatch):
    """On CPU tensors the kernel route goes through ``gn_stats`` and
    ``gn_apply`` (their plain versions); the default route does not."""
    calls = []
    for name in ("gn_stats", "gn_apply"):
        fn = getattr(tgn, name)
        monkeypatch.setattr(tgn, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    i = _inputs((2, 8, 8, 16), True, False, seed=1)
    _set_route(monkeypatch, None)
    _call(tgn.group_norm_silu, t_, i, 8)
    assert calls == []
    _set_route(monkeypatch, "pallas")
    _call(tgn.group_norm_silu, t_, i, 8)
    assert calls == ["gn_stats", "gn_apply"]


@pytest.mark.parametrize("value", [None, "xla", "pallas", "", "XLA", "kernel"])
def test_gn_route_reads_what_jax_reads(value, monkeypatch):
    """The JAX package takes its plain route exactly when it calls
    ``_gn_silu_xla``; the port's reader agrees on every value."""
    _set_route(monkeypatch, value)
    plain = []
    xla = jgn._gn_silu_xla
    monkeypatch.setattr(jgn, "_gn_silu_xla", lambda *a: plain.append(1) or xla(*a))
    x = jnp.ones((1, 4, 4, 8))
    jgn.group_norm_silu(x, jnp.ones(8), jnp.zeros(8), groups=4)
    assert tgn.gn_route() == (not plain)


@pytest.mark.parametrize("value,on", [(None, False), ("1", True), ("0", False),
                                      ("true", False), ("", False), (" 1", False)])
def test_unified_route_reads_what_jax_reads(value, on, monkeypatch):
    """``FOUNDDIFF_UNIFIED`` turns the route on only at ``"1"``
    (founddiff_tpu/models/ss2d.py:229)."""
    if value is None:
        monkeypatch.delenv("FOUNDDIFF_UNIFIED", raising=False)
    else:
        monkeypatch.setenv("FOUNDDIFF_UNIFIED", value)
    assert tun.unified_route() is on


def _chunked(ms, mt):
    """ms, mt [B, C] as the ``.chunk`` views of one [B, 2C] tensor."""
    return t_(np.concatenate([ms, mt], axis=-1)).chunk(2, dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ROUTES)
def test_group_norm_silu_chunked_scale_shift(route, dtype, monkeypatch):
    """The scale/shift as strided views, as the vanilla block1 passes it."""
    _set_route(monkeypatch, route)
    shape = (2, 12, 10, 16)
    i = _inputs(shape, False, True, seed=21)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _call(jgn.group_norm_silu,
                 lambda a: jnp.asarray(a, jdt if a.shape == shape else jnp.float32), i, 4)
    ss = _chunked(*i["scale_shift"])
    assert ss[0].stride() == (32, 1)
    got = tgn.group_norm_silu(t_(i["x"]).to(tdt), t_(i["scale"]), t_(i["bias"]),
                              scale_shift=ss, groups=4)
    w, g = np.asarray(want, np.float32), np_(got)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    else:
        assert (np.abs(g - w) <= _ulp_bf16(np.maximum(np.abs(g), np.abs(w)))).all()


@pytest.mark.parametrize("res,ss", [(True, False), (False, True), (True, True)])
def test_direct_and_function_paths_agree(res, ss, monkeypatch):
    """The kernel route without a gradient (the direct call) and with one
    (``GroupNormSiLUFn``) run the same forward: the same bits."""
    _set_route(monkeypatch, "pallas")
    i = _inputs((2, 8, 6, 16), res, ss, seed=3 + res)
    direct = _call(tgn.group_norm_silu, t_, i, 8)
    conv = lambda a: t_(a).requires_grad_(True)
    through_fn = _call(tgn.group_norm_silu, conv, i, 8)
    assert through_fn.grad_fn is not None and direct.grad_fn is None
    assert torch.equal(direct, through_fn.detach())


@pytest.mark.parametrize("ss,groups", [(False, 8), (True, 4)])
def test_coefficient_table_against_float64(ss, groups):
    """``gn_stats_plain``'s table against the group statistics and the folded
    affine in float64: a = rstd * g, c = b - mean * a."""
    i = _inputs((2, 12, 10, 16), False, ss, seed=30 + groups)
    B, H, W, C = i["x"].shape
    x3 = i["x"].reshape(B, H * W, C)
    ms, mt = i["scale_shift"] or (None, None)
    table = np_(tgn.gn_stats_plain(t_(x3), t_(i["scale"]), t_(i["bias"]),
                                   None if ms is None else t_(ms),
                                   None if mt is None else t_(mt), groups, 1e-5))
    xg = x3.astype(np.float64).reshape(B, H * W, groups, C // groups)
    mean = np.repeat(xg.mean(axis=(1, 3)), C // groups, axis=-1)
    rstd = np.repeat(1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5), C // groups, axis=-1)
    g = np.broadcast_to(i["scale"].astype(np.float64), (B, C))
    b = np.broadcast_to(i["bias"].astype(np.float64), (B, C))
    if ms is not None:
        g, b = g * (ms + 1.0), b * (ms + 1.0) + mt
    a = rstd * g
    np.testing.assert_allclose(table[:, 0], a, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(table[:, 1], b - mean * a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_chunked_scale_shift_gradients(route, monkeypatch):
    """With no residual and the scale/shift as views of one [B, 2C] leaf
    (the time MLP's output): the leaf's gradient is JAX's d/d(ms, mt)."""
    _set_route(monkeypatch, route)
    shape = (2, 12, 10, 16)
    i = _inputs(shape, False, True, seed=19)
    w = np.random.default_rng(20).standard_normal(shape).astype(np.float32)
    ms, mt = i["scale_shift"]

    def loss(x, scale, bias, ms, mt):
        out = jgn.group_norm_silu(x, scale, bias, scale_shift=(ms, mt), groups=4)
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, (i["x"], i["scale"], i["bias"], ms, mt)))
    ts = [t_(v).requires_grad_(True) for v in (i["x"], i["scale"], i["bias"])]
    mod = t_(np.concatenate([ms, mt], axis=-1)).requires_grad_(True)
    out = tgn.group_norm_silu(*ts, scale_shift=mod.chunk(2, dim=-1), groups=4)
    (out * t_(w)).sum().backward()
    got = [np_(t.grad) for t in ts] + list(np.split(np_(mod.grad), 2, axis=-1))
    for name, g, ref in zip(("x", "scale", "bias", "ms", "mt"), got, want):
        ref = np.asarray(ref)
        err = np.linalg.norm(g - ref)
        assert err <= 1e-4 * np.linalg.norm(ref), (name, err, np.linalg.norm(ref))
