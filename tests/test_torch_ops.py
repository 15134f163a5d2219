"""Port ops (plain versions, CPU) against the JAX package at shared inputs.

Tolerances: rtol 1e-3 / atol 1e-4, fp32 on both sides; the sums run in
another order (and the JAX kernels in Pallas interpret mode), so the two
agree to fp32 rounding, well inside these bounds.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.ops import attn_block as jattn
from founddiff_tpu.ops import norm_pallas as jnorm
from founddiff_tpu.ops import ss2d_block as jblock
from founddiff_tpu_torch.ops import attn_block as tattn
from founddiff_tpu_torch.ops import norm as tnorm
from founddiff_tpu_torch.ops import selective_scan as tscan
from founddiff_tpu_torch.ops import ss2d_block as tblock
from torch_parity import np_, t_

# the ops package re-exports a function named selective_scan over the module
jscan = importlib.import_module("founddiff_tpu.ops.selective_scan")

RTOL, ATOL = 1e-3, 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


# --- layer_norm_modulated -------------------------------------------------


@pytest.mark.parametrize("affine,eps", [(True, 1e-5), (False, 1e-6)])
def test_layer_norm_modulated(affine, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal(64).astype(np.float32) * 0.1 + 1 if affine else None
    b = rng.standard_normal(64).astype(np.float32) * 0.1 if affine else None
    ms = rng.standard_normal((2, 64)).astype(np.float32) * 0.2
    mt = rng.standard_normal((2, 64)).astype(np.float32) * 0.2
    want = jnorm.layer_norm_modulated(
        jnp.asarray(x), None if g is None else jnp.asarray(g),
        None if b is None else jnp.asarray(b), jnp.asarray(ms), jnp.asarray(mt), eps=eps)
    got = tnorm.layer_norm_modulated(
        t_(x), None if g is None else t_(g), None if b is None else t_(b), t_(ms), t_(mt),
        eps=eps)
    _close(got, want)
    assert tnorm.layer_norm_modulated.launches == 0  # CPU never launches


# --- selective scan and layouts -------------------------------------------


def test_efficient_scan_merge_roundtrip():
    x = np.random.default_rng(1).standard_normal((2, 6, 8, 3)).astype(np.float32)
    seq = tscan.efficient_scan(t_(x), 2)
    _close(seq, jscan.efficient_scan(jnp.asarray(x), 2), 0, 0)
    _close(tscan.efficient_merge(seq, 6, 8, 2), x, 0, 0)


@pytest.mark.parametrize("L,chunk", [(64, None), (37, 8)])
def test_selective_scan_chunked(L, chunk):
    rng = np.random.default_rng(L)
    B, K, D, N = 2, 4, 16, 4
    u = rng.standard_normal((B, K, L, D)).astype(np.float32)
    dl = rng.standard_normal((B, K, L, D)).astype(np.float32) * 0.5
    A = -np.exp(rng.standard_normal((K, D, N)).astype(np.float32))
    Bm = rng.standard_normal((B, K, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, K, L, N)).astype(np.float32)
    Ds = rng.standard_normal((K, D)).astype(np.float32)
    bias = rng.standard_normal((K, D)).astype(np.float32) * 0.1
    want = jscan.selective_scan_ref(*map(jnp.asarray, (u, dl, A, Bm, Cm, Ds, bias)))
    got = tscan.selective_scan_chunked(*map(t_, (u, dl, A, Bm, Cm, Ds, bias)), chunk=chunk)
    _close(got, want)


# --- ss2d_image_block -----------------------------------------------------


def _block_inputs(B, H, W, C0, D, N, R, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return dict(
        x1=f(B, H, W, C0) * 0.5, xs=f(B, H, W, D) * 0.5, xr=f(B, H, W, C0),
        wz=f(C0, D) * 0.05, xw=f(4, R + 2 * N, D) * 0.05, dtw=f(4, D, R) * 0.1,
        A=-np.abs(f(4, D, N)), Ds=f(4, D), bias=f(4, D) * 0.1,
        lng=f(D) * 0.1 + 1, lnb=f(D) * 0.1, loc=f(B, D) * 0.2,
        pw=f(D, C0) * 0.05, gate=f(B, C0) * 0.3,
    )


def _block_call(mod, i, R, N, local, conv):
    return mod.ss2d_image_block(
        conv(i["x1"]), conv(i["xs"]), conv(i["xr"]), w_z=conv(i["wz"]),
        x_proj_weight=conv(i["xw"]), dt_projs_weight=conv(i["dtw"]), A=conv(i["A"]),
        Dskip=conv(i["Ds"]), delta_bias=conv(i["bias"]), ln_g=conv(i["lng"]),
        ln_b=conv(i["lnb"]), local=conv(i["loc"]) if local else None,
        proj_w=conv(i["pw"]), gate=conv(i["gate"]), dt_rank=R, d_state=N)


@pytest.mark.parametrize("B,H,W,C0,D,N,R,local", [
    (2, 16, 16, 32, 64, 4, 2, True),
    (1, 8, 12, 16, 32, 8, 1, True),
    (1, 8, 8, 16, 32, 4, 1, False),
])
def test_ss2d_image_block(B, H, W, C0, D, N, R, local):
    i = _block_inputs(B, H, W, C0, D, N, R, seed=H + W + C0)
    got = _block_call(tblock, i, R, N, local, t_)
    want = _block_call(jblock, i, R, N, local, jnp.asarray)  # Pallas, interpret mode
    _close(got, want)
    wd, wb, wc = jblock._derive_weights(jnp.asarray(i["xw"]), jnp.asarray(i["dtw"]), R, N)
    oracle = jblock._xla_compose(
        *map(jnp.asarray, (i["x1"], i["xs"], i["xr"], i["wz"])), wd, wb, wc,
        *map(jnp.asarray, (i["A"], i["Ds"], i["bias"], i["lng"], i["lnb"], i["loc"],
                           i["pw"], i["gate"])), True, local, 1e-5)
    _close(got, oracle)
    assert tblock.ss2d_image_block.launches == 0


# --- attn_block -----------------------------------------------------------


def _attn_inputs(B, H, W, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    heads = max(1, C // 32)
    return heads, dict(
        x=f(B, H, W, C), ms=f(B, C) * 0.2, mt=f(B, C) * 0.2, gate=f(B, C) * 0.5,
        qkv=f(1, 1, C, 3 * C) * C ** -0.5, dw=f(3, 3, 1, 3 * C) / 3,
        temp=np.abs(f(heads, 1, 1)) + 0.5, proj=f(1, 1, C, C) * C ** -0.5)


@pytest.mark.parametrize("C", [128, 32])
def test_attn_block(C):
    heads, i = _attn_inputs(2, 8, 8, C, seed=C)
    assert tattn.attn_block_ok(8, 8, C) and jattn.attn_block_ok(8, 8, C)
    # port weights in the reference layout: conv kernels HWIO -> OIHW
    oihw = lambda k: t_(np.transpose(k, (3, 2, 0, 1)))
    got = tattn.attn_block(t_(i["x"]), t_(i["ms"]), t_(i["mt"]), t_(i["gate"]),
                           oihw(i["qkv"]), oihw(i["dw"]), t_(i["temp"]), oihw(i["proj"]),
                           heads=heads, eps=1e-6)
    jargs = (jnp.asarray(i["x"]), jnp.asarray(i["ms"]), jnp.asarray(i["mt"]),
             jnp.asarray(i["gate"]), jnp.asarray(i["qkv"][0, 0]), jnp.asarray(i["dw"]),
             jnp.asarray(i["temp"]), jnp.asarray(i["proj"]))
    _close(got, jattn.attn_block(*jargs, heads=heads, eps=1e-6))  # interpret mode
    _close(got, jattn.attn_block_xla(*jargs, heads, 1e-6))
    assert tattn.attn_block.launches == 0
    assert tattn.attn_block_route(8, 8, C) == (C >= 128)
