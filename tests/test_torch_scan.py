"""The port's scans and the backward of its kernel Functions (CPU, plain
versions) against the JAX package.

JAX runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_selective_scan.py`` does, and differentiates them through their
``custom_vjp``s: ``selective_scan_pallas`` (``_scan_kernel`` forward,
``_scan_bwd_kernel`` backward), ``selective_scan_image``
(``_scan_kernel_image`` forward, ``_scan_image_bwd``), and the fused block,
attention and norm ops (remat backward).  Inputs are made with numpy from a
seed.  fp32 throughout; rtol 1e-3 / atol 1e-4 on values and gradients (the
same math summed in another order and another chunking of L).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import founddiff_tpu.ops.scan_pallas as jsp
from founddiff_tpu.ops.attn_block import attn_block as j_attn_block
from founddiff_tpu.ops.norm_pallas import layer_norm_modulated as j_ln_mod
from founddiff_tpu.ops.ss2d_block import ss2d_image_block as j_ss2d_block
from founddiff_tpu_torch.ops import scan as tscan
from founddiff_tpu_torch.ops import ss2d_block as tss2d
from founddiff_tpu_torch.ops.attn_block import attn_block as t_attn_block
from founddiff_tpu_torch.ops.norm import layer_norm_modulated as t_ln_mod
from torch_parity import jit_quick, np_, t_

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _scan_inputs(Bsz, K, L, D, N, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return (f(Bsz, K, L, D), f(Bsz, K, L, D) * 0.5, -np.abs(f(K, D, N)), f(Bsz, K, L, N),
            f(Bsz, K, L, N), f(K, D), f(K, D) * 0.1)


def _jax_value_and_grads(fn, args):
    def loss(*a):
        y = fn(*a)
        return jnp.sum(jnp.tanh(y)), y

    (_, y), grads = jit_quick(jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                                 has_aux=True))(*map(jnp.asarray, args))
    return y, grads


def _torch_value_and_grads(fn, args):
    xs = [t_(a).requires_grad_() for a in args]
    y = fn(*xs)
    return y, torch.autograd.grad(torch.tanh(y).sum(), xs)


@pytest.mark.parametrize("shape,jax_chunk,chunk", [
    ((1, 2, 24, 128, 4), None, None),   # one chunk on both sides
    ((2, 4, 75, 8, 4), 16, 8),          # many chunks, a padded last chunk
    ((2, 4, 40, 16, 8), 16, 16),
])
def test_selective_scan_and_seven_grads(shape, jax_chunk, chunk, monkeypatch):
    """``SelectiveScanFn`` and the plain kernel versions against jax.grad of
    ``selective_scan_pallas`` (interpret mode): y and all seven gradients."""
    if jax_chunk:
        monkeypatch.setattr(jsp, "_pick_chunk", lambda G, D, N, L: jax_chunk)
    args = _scan_inputs(*shape, seed=sum(shape))
    y_j, g_j = _jax_value_and_grads(jsp.selective_scan_pallas, args)
    y_t, g_t = _torch_value_and_grads(
        lambda *a: tscan.selective_scan(*a, chunk=chunk), args)
    _close(y_t, y_j, "y")
    names = ("u", "delta", "A", "B", "C", "Dskip", "delta_bias")
    for n, a, b in zip(names, g_t, g_j):
        _close(a, b, n)
    # the plain versions called directly, as the card's checks call them
    N = shape[-1]
    ch = chunk or tscan.scan_chunk(N)
    ts = [t_(a) for a in args]
    y_p, hb = tscan.scan_forward_plain(*ts, ch)
    assert hb.shape == (shape[0] * shape[1], -(-shape[2] // ch), N, shape[3])
    _close(y_p, y_j, "plain y")
    dy = 1.0 - torch.tanh(y_p) ** 2
    for n, a, b in zip(names, tscan.scan_backward_plain(*ts, hb, dy, ch), g_j):
        _close(a, b, "plain " + n)


def test_scan_chunk_bounds_shared_memory():
    for N in (4, 8, 16, 32):
        assert tscan.scan_chunk(N) * N * 32 * 4 <= 32 * 1024


def _image_inputs(B, H, W, D, N, R, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return (f(B, H, W, D) * 0.5, f(4, R + 2 * N, D) * 0.1, f(4, D, R) * 0.3,
            -np.abs(f(4, D, N)), f(4, D), f(4, D) * 0.1)


@pytest.mark.parametrize("B,H,W,D,N,R", [(2, 8, 12, 32, 4, 2), (1, 16, 16, 64, 8, 4)])
def test_selective_scan_image_and_grads(B, H, W, D, N, R):
    """``ScanImageFn`` on the weights that ``_derive_weights`` folds, as
    ``ss2d_compose`` calls it, against jax.grad of the JAX
    ``selective_scan_image``, whose (rows, cols) pairs are dirs (0, 2) and
    (1, 3); the x_proj and dt_projs gradients flow back through the fold."""
    args = _image_inputs(B, H, W, D, N, R, seed=H + W + D)

    def jfn(x, xw, dtw, A, Ds, bias):
        rows, cols = jsp.selective_scan_image(x, xw, dtw, A, Ds, bias, dt_rank=R, d_state=N)
        return jnp.stack([rows[:, 0], cols[:, 0], rows[:, 1], cols[:, 1]], axis=1)

    def tfn(x, xw, dtw, A, Ds, bias):
        return tscan.ScanImageFn.apply(x, *tss2d._derive_weights(xw, dtw, R, N), A, Ds, bias)

    y_j, g_j = _jax_value_and_grads(jfn, args)
    y_t, g_t = _torch_value_and_grads(tfn, args)
    _close(y_t, y_j, "ys")
    for n, a, b in zip(("x", "x_proj", "dt_projs", "A", "Dskip", "delta_bias"), g_t, g_j):
        _close(a, b, n)


def test_image_scan_vmem_ok_routes_the_shipped_unet():
    """The JAX predicate, copied: at 512^2 (dim 64, mults 1,2,4,8) the five
    shallow blocks take the image scan and the four deep ones do not."""
    blocks = [(512, 128, 4), (256, 128, 8), (128, 256, 16), (64, 512, 32), (64, 1024, 32),
              (64, 1024, 32), (128, 512, 16), (256, 256, 8), (512, 128, 4)]
    got = [tscan.image_scan_vmem_ok(H, H, D, N) for H, D, N in blocks]
    assert got == [jsp.image_scan_vmem_ok(H, H, D, N) for H, D, N in blocks]
    assert sum(got) == 5


def _block_inputs(B, H, W, C0, N, R, seed):
    D = 2 * C0
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return dict(x1=f(B, H, W, C0) * 0.5, xs=f(B, H, W, D) * 0.5, xr=f(B, H, W, C0),
                wz=f(C0, D) * 0.05, xw=f(4, R + 2 * N, D) * 0.05, dtw=f(4, D, R) * 0.1,
                A=-np.abs(f(4, D, N)), Ds=f(4, D), bias=f(4, D) * 0.1,
                lng=f(D) * 0.1 + 1, lnb=f(D) * 0.1, loc=f(B, D) * 0.2, pw=f(D, C0) * 0.05,
                gate=f(B, C0) * 0.3)


@pytest.mark.parametrize("route,local", [("image", True), ("deep", False)])
def test_ss2d_image_block_grads(route, local, monkeypatch):
    """Every gradient of ``ss2d_image_block`` (kernel Function: plain forward,
    backward through ``ss2d_compose``) against jax.grad of the JAX op, on the
    image-scan route and, with the route predicate forced off on both sides,
    on the decimated-scan route."""
    if route == "deep":
        monkeypatch.setattr(jsp, "image_scan_vmem_ok", lambda *a: False)
        monkeypatch.setattr(tss2d, "image_scan_vmem_ok", lambda *a: False)
    R, N = 2, 4
    i = _block_inputs(2, 8, 12, 16, N, R, seed=11)
    keys = ["x1", "xs", "xr", "wz", "xw", "dtw", "A", "Ds", "bias", "lng", "lnb", "loc",
            "pw", "gate"]
    if not local:
        keys.remove("loc")

    def call(op, v):
        kw = dict(zip(keys, v))
        return op(kw["x1"], kw["xs"], kw["xr"], kw["wz"], kw["xw"], kw["dtw"], kw["A"],
                  kw["Ds"], kw["bias"], kw["lng"], kw["lnb"], kw.get("loc"), kw["pw"],
                  kw["gate"], dt_rank=R, d_state=N)

    args = [i[k] for k in keys]
    y_j, g_j = _jax_value_and_grads(lambda *v: call(j_ss2d_block, v), args)
    y_t, g_t = _torch_value_and_grads(lambda *v: call(tss2d.ss2d_image_block, v), args)
    _close(y_t, y_j, "out")
    for n, a, b in zip(keys, g_t, g_j):
        _close(a, b, n)


def test_attn_block_grads():
    rs = np.random.RandomState(5)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    C, heads = 128, 4
    args = [f(2, 8, 8, C), f(2, C) * 0.2, f(2, C) * 0.2, f(2, C) * 0.5, f(C, 3 * C) * 0.05,
            f(3, 3, 1, 3 * C) * 0.3, np.abs(f(heads, 1, 1)) * 0.3 + 0.5, f(C, C) * 0.05]
    y_j, g_j = _jax_value_and_grads(
        lambda x, ms, mt, g, q, dw, tmp, pw: j_attn_block(x, ms, mt, g, q, dw, tmp,
                                                          pw[None, None], heads=heads), args)

    def tfn(x, ms, mt, g, q, dw, tmp, pw):  # JAX layouts -> reference layouts
        return t_attn_block(x, ms, mt, g, q.t()[..., None, None], dw.permute(3, 2, 0, 1),
                            tmp, pw.t()[..., None, None], heads=heads)

    y_t, g_t = _torch_value_and_grads(tfn, args)
    _close(y_t, y_j, "out")
    for n, a, b in zip(("x", "mod_scale", "mod_shift", "gate", "qkv", "dwconv",
                        "temperature", "project_out"), g_t, g_j):
        _close(a, b, n)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_modulated_grads(affine):
    rs = np.random.RandomState(6)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    x, ms, mt = f(2, 6, 10, 64) + 0.3, f(2, 64) * 0.2, f(2, 64) * 0.2
    g, b = f(64) * 0.1 + 1, f(64) * 0.1
    args = [x, ms, mt] + ([g, b] if affine else [])

    def call(op, x, ms, mt, *gb):
        return op(x, *(gb or (None, None)), ms, mt, eps=1e-5)

    y_j, g_j = _jax_value_and_grads(lambda *a: call(j_ln_mod, *a), args)
    y_t, g_t = _torch_value_and_grads(lambda *a: call(t_ln_mod, *a), args)
    _close(y_t, y_j, "out")
    for n, a, bb in zip(("x", "mod_scale", "mod_shift", "scale", "bias"), g_t, g_j):
        _close(a, bb, n)
