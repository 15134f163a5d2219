"""Faults of the port against the JAX package, each held by a CPU test.

1. ``d_state`` 64: a five-level UNet gives its deepest level ``base_d_state
   * 2^4 = 64`` (``founddiff_tpu/models/unet.py:133-137``).  The CUDA
   wrappers take it: each reaches its launch with N = 64 and the scan chunk
   of :func:`scan_chunk` (a recording stand-in for the kernel library on
   CPU tensors), and a five-level micro UNet with N = 64 at shared weights
   matches the JAX ``UnetRes``.
2. ``build(Config(...))`` builds what the JAX factory builds: FoundDiff with
   ``base_d_state`` 4, ``ssm_expand`` 2.0 and ``resnet_block_groups`` 8
   whatever the Config says (``founddiff_tpu/factory.py:33-46``), with a
   warning that names each field it ignores.

The other two faults: the bf16 guard in ``tests/test_torch_bf16_guard.py``,
the UNet variants in ``tests/test_torch_variants.py`` and
``tests/test_torch_partial_load.py``.

JAX runs its ``chunked`` CPU route, the port its TPU routing through the
plain versions.  fp32 throughout; rtol 1e-3 / atol 1e-4, as the other port
tests.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.config import Config as JConfig
from founddiff_tpu.factory import build_denoiser as j_build_denoiser
from founddiff_tpu.models.unet import UnetRes as JUnetRes
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import JAX_FIXED, build
from founddiff_tpu_torch.models.unet import UnetRes
from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.ops import experimental_unified as tunified
from founddiff_tpu_torch.ops import scan as tscan
from founddiff_tpu_torch.ops import ss2d_block as tblock
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=atol)


# --- 1. d_state 64 --------------------------------------------------------------


class _Recorder:
    """A stand-in for a kernel library: every C function records its int
    arguments (by the argtypes ``_build.declare`` set) and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn.startswith("__"):
            raise AttributeError(fn)
        calls = self.calls

        def f(*args):
            calls.append((fn, [a for a, t in zip(args, f.argtypes) if t is ctypes.c_int]))
            return 0

        f.argtypes, f.restype = None, None
        setattr(self, fn, f)
        return f


def _scan_case(N, B=1, L=12, D=16):
    rs = np.random.RandomState(N)
    f = lambda *s: t_(rs.randn(*s) * 0.3)
    return dict(u=f(B, 4, L, D), delta=f(B, 4, L, D), A=-t_(rs.rand(4, D, N) + 0.1),
                B=f(B, 4, L, N), C=f(B, 4, L, N), Ds=f(4, D), bias=f(4, D), x=f(B, 6, 8, D),
                wd=f(4, D, D), wb=f(4, D, N), wc=f(4, D, N))


def _launch_forward(c, N):
    return tscan._scan_forward_cuda(c["u"], c["delta"], c["A"], c["B"], c["C"], c["Ds"],
                                    c["bias"], tscan.scan_chunk(N))


def _launch_backward(c, N):
    chunk = tscan.scan_chunk(N)
    _, hb = tscan.scan_forward_plain(c["u"], c["delta"], c["A"], c["B"], c["C"], c["Ds"],
                                     c["bias"], chunk)
    return tscan._scan_backward_cuda(c["u"], c["delta"], c["A"], c["B"], c["C"], c["Ds"],
                                     c["bias"], hb, c["u"], chunk)


def _launch_fused(c, N):
    return tscan._scan_fused_cuda(c["u"], c["wd"], c["wb"], c["wc"], c["A"], c["Ds"],
                                  c["bias"], tscan.scan_chunk(N))


def _launch_image(c, N):
    return tscan._scan_image_cuda(c["x"], c["wd"], c["wb"], c["wc"], c["A"], c["Ds"],
                                  c["bias"])


def _block_args(c, N, D=16):
    C0, B = D // 2, 1
    rs = np.random.RandomState(N + 1)
    f = lambda *s: t_(rs.randn(*s) * 0.3)
    return (f(B, 6, 8, C0), c["x"], f(B, 6, 8, C0), f(C0, D), c["wd"], c["wb"], c["wc"],
            c["A"], c["Ds"], c["bias"], f(D), f(D), f(B, D), f(D, C0), f(B, C0))


def _launch_block(c, N):
    return tblock._ss2d_block_cuda(*_block_args(c, N), 1e-5)


def _launch_mamba(c, N, D=16):
    C0 = D // 2
    rs = np.random.RandomState(N + 2)
    f = lambda *s: t_(rs.randn(*s) * 0.3)
    x1, _, xr, _, _, _, _, A, Ds, bias, g, b, local, _, gate = _block_args(c, N)
    args = tunified._split_args(
        xr, f(C0), f(C0), f(1, C0), f(1, C0), f(2 * D, C0), f(D, 1, 3, 3), f(D),
        f(4, 2 + 2 * N, D), f(4, D, 2), A, Ds, bias, g, b, local, f(C0, D), gate, D, 2, N)
    return tunified._mamba_block_cuda(*args, 1e-5, 1e-5)


# (wrapper, library, C function, index of N among the call's int arguments)
_LAUNCHES = [
    (_launch_forward, "scan", "scan_forward", 4),
    (_launch_backward, "scan", "scan_backward", 4),
    (_launch_fused, "scan", "scan_fused_forward", 3),
    (_launch_image, "scan_image", "scan_image_forward", 4),
    (_launch_block, "ss2d_block", "ss2d_block_forward", 5),
    (_launch_mamba, "mamba_block", "mamba_block_forward", 5),
]


@pytest.mark.parametrize("launch,lib,fn,n_at", _LAUNCHES, ids=[c[2] for c in _LAUNCHES])
def test_cuda_wrappers_take_d_state_64(monkeypatch, launch, lib, fn, n_at):
    """Each CUDA wrapper, on CPU tensors with the library replaced by a
    recorder, checks its operands and launches with N = 64 (and, for the
    chunked scans, the chunk of ``scan_chunk(64)``); a state size the
    kernels lack raises before any launch."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "_LIBS", {lib: rec})
    monkeypatch.setattr(_build, "_DECLARED", {})
    monkeypatch.setattr(_build, "stream", lambda: 0)
    launch(_scan_case(64), 64)
    assert [c[0] for c in rec.calls] == [fn]
    ints = rec.calls[0][1]
    assert ints[n_at] == 64
    if fn in ("scan_forward", "scan_backward", "scan_fused_forward"):
        assert ints[n_at + 1] == tscan.scan_chunk(64) == 8
    with pytest.raises(ValueError):
        launch(_scan_case(12), 12)
    assert len(rec.calls) == 1


FIVE = (1, 2, 4, 8, 16)


def test_five_level_unet_d_state_64():
    """A five-level micro UnetRes (dim 8 x (1, 2, 4, 8, 16) at 64^2: N = 64
    at its 4x4 deepest grid, on the fused block) at shared weights."""
    jm = JUnetRes(dim=8, dim_mults=FIVE, objective="pred_res", condition=True,
                  scan_impl="chunked")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, 64, 2)).astype(np.float32)
    time = [np.array([250.0], np.float32), np.array([20.0], np.float32)]
    init = jit_quick(jm.init)(jax.random.PRNGKey(5), jnp.asarray(x), [jnp.asarray(t) for t in time])
    params = perturb(init["params"], seed=5)
    want = jit_quick(lambda p, v, t: jm.apply({"params": p}, v, t))(
        params, jnp.asarray(x), [jnp.asarray(t) for t in time])
    port = load_port(UnetRes(8, FIVE, objective="pred_res", condition=True), params)
    assert port.unet0.mid_attn.mamba.d_state == 64
    _close(port(t_(x), [t_(t) for t in time])[0], want[0])


# --- 2. the Config fields the JAX build ignores --------------------------------


def test_build_ignores_what_jax_ignores():
    overrides = dict(base_d_state=8, ssm_expand=1.5, resnet_block_groups=4)
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.model.dim, c.model.dim_mults = 8, (1, 2)
        for k, v in overrides.items():
            setattr(c.model, k, v)
    with pytest.warns(UserWarning) as caught:
        _, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP)
    text = " ".join(str(w.message) for w in caught)
    for k, v in overrides.items():
        assert f"{k}={v}" in text and f"{k}={JAX_FIXED[k]}" in text
    assert [m.mamba.d_state for _, m, _ in model.unet0.downs] == [4, 8]
    assert model.unet0.downs[0][1].mamba.d_inner == 2 * 8
    assert model.unet0.mid_block.block1.norm.num_groups == 8
    jm = j_build_denoiser(jcfg).clone(clip_overrides=MICRO_CLIP)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2)),
                            [jnp.zeros((1,)), jnp.zeros((1,))])["params"]
    # the JAX model's tree loads strictly: the same keys and shapes
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)), strict=True)


def test_build_at_the_jax_values_does_not_warn(recwarn):
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    build(cfg, device="cpu", clip_overrides=MICRO_CLIP)
    assert not [w for w in recwarn if "JAX package builds" in str(w.message)]
