"""Faults of the port against the JAX package, each held by a CPU test.

1. ``d_state``: a five-level UNet gives its deepest level ``base_d_state
   * 2^4 = 64`` (``founddiff_tpu/models/unet.py:133-137``), a six-level one
   128, and a UNet built with another ``base_d_state`` sizes that are no
   power of two.  The CUDA wrappers take any of them: each reaches its
   launch (a recording stand-in for the kernel library on CPU tensors) with
   the scan chunk of :func:`scan_chunk`, ``scan_forward``/``scan_backward``
   at the caller's N, the register-resident kernels at N padded to 4, 8,
   16, 32 or 64, or to a multiple of 64 run in groups with an fp32 y
   buffer; a five-level micro UNet with N = 64 at shared weights matches
   the JAX ``UnetRes``.  The recorder launches leave every launch counter
   as they found it (a counter they left raised failed the "CPU never
   launches" checks of the files that ran after this one on a worker).
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
from founddiff_tpu_torch.utils import trace
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, jit_quick, load_port, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=atol)


# --- 1. d_state 64 --------------------------------------------------------------


class _Recorder:
    """A stand-in for a kernel library: every C function records its int
    arguments and its pointer arguments (by the argtypes ``_build.declare``
    set) and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn.startswith("__"):
            raise AttributeError(fn)
        calls = self.calls

        def f(*args):
            calls.append((fn, [a for a, t in zip(args, f.argtypes) if t is ctypes.c_int],
                          [a for a, t in zip(args, f.argtypes) if t is ctypes.c_void_p]))
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


def _mamba_raw(c, N, D=16):
    """``ss2d_mamba_block``'s arguments at N states."""
    C0 = D // 2
    rs = np.random.RandomState(N + 2)
    f = lambda *s: t_(rs.randn(*s) * 0.3)
    x1, _, xr, _, _, _, _, A, Ds, bias, g, b, local, _, gate = _block_args(c, N)
    return (xr, f(C0), f(C0), f(1, C0), f(1, C0), f(2 * D, C0), f(D, 1, 3, 3), f(D),
            f(4, 2 + 2 * N, D), f(4, D, 2), A, Ds, bias, g, b, local, f(C0, D), gate, D, 2, N)


def _launch_mamba(c, N):
    return tunified._mamba_block_cuda(*tunified._split_args(*_mamba_raw(c, N)), 1e-5, 1e-5)


# (wrapper, library, C function, index of N among the call's int arguments,
# index of the fp32 y buffer of N > 64 among its pointer arguments; the
# backward's sums over n: two buffers from that index)
_LAUNCHES = [
    (_launch_forward, "scan", "scan_forward", 4, 10),
    (_launch_backward, "scan", "scan_backward", 4, 23),
    (_launch_fused, "scan", "scan_fused_forward", 3, 9),
    (_launch_image, "scan_image", "scan_image_forward", 4, 9),
    (_launch_block, "ss2d_block", "ss2d_block_forward", 5, 18),
    (_launch_mamba, "mamba_block", "mamba_block_forward", 5, 23),
]
_RUNTIME_N = ("scan_forward", "scan_backward")  # N as the caller gives it
# every counter a recorder launch raises
_COUNTED = ("scan_forward", "scan_backward", "scan_fused_forward", "scan_image_forward",
            "ss2d_block_forward", "mamba_block_forward")


def _counters():
    counts = trace.counters()
    return [counts.get(n, 0) for n in _COUNTED]


def _record(mp, launch, lib, N):
    """``launch`` at N against a recorder for ``lib``; the launch counters
    are restored from a snapshot of the registry when ``mp`` undoes its
    patches.  Returns the recorder and the shapes the wrapper checked its
    operands at."""
    mp.setattr(trace, "_counts", dict(trace._counts))
    rec, shapes = _Recorder(), {}
    expect = _build.expect

    def seen(device, **named):
        shapes.update({k: tuple(t.shape) for k, (t, _) in named.items() if t is not None})
        expect(device, **named)

    mp.setattr(_build, "_LIBS", {lib: rec})
    mp.setattr(_build, "_DECLARED", {})
    mp.setattr(_build, "stream", lambda: 0)
    mp.setattr(_build, "expect", seen)
    launch(_scan_case(N), N)
    return rec, shapes


@pytest.mark.parametrize("launch,lib,fn,n_at,y_at", _LAUNCHES, ids=[c[2] for c in _LAUNCHES])
def test_cuda_wrappers_take_d_state_64(monkeypatch, launch, lib, fn, n_at, y_at):
    """Each CUDA wrapper, on CPU tensors with the library replaced by a
    recorder, checks its operands and launches with N = 64 (and, for the
    chunked scans, the chunk of ``scan_chunk(64)``); at N = 12, a size no
    register-resident kernel is built for, it launches too (padded to 16
    there, as it is elsewhere)."""
    rec, _ = _record(monkeypatch, launch, lib, 64)
    assert [c[0] for c in rec.calls] == [fn]
    ints = rec.calls[0][1]
    assert ints[n_at] == 64
    if fn in ("scan_forward", "scan_backward", "scan_fused_forward"):
        assert ints[n_at + 1] == tscan.scan_chunk(64) == 8
    launch(_scan_case(12), 12)
    assert [c[0] for c in rec.calls] == [fn, fn]
    assert rec.calls[1][1][n_at] == (12 if fn in _RUNTIME_N else 16)


@pytest.mark.parametrize("N", [12, 128])
@pytest.mark.parametrize("launch,lib,fn,n_at,y_at", _LAUNCHES, ids=[c[2] for c in _LAUNCHES])
def test_cuda_wrappers_take_any_d_state(monkeypatch, launch, lib, fn, n_at, y_at, N):
    """N = 12 and 128 through every CUDA wrapper: scan_forward/backward at
    the caller's N, the others padded (12 -> 16: B and C columns and w_b,
    w_c rows of zeros, A -1) or, at 128, in groups of 64 with the fp32 y
    buffer (the backward: its two sums over n); the chunk of the caller's
    N; the operands at the launched N; no ValueError."""
    rec, shapes = _record(monkeypatch, launch, lib, N)
    assert [c[0] for c in rec.calls] == [fn]
    _, ints, ptrs = rec.calls[0]
    Nk = N if fn in _RUNTIME_N else tscan.kernel_states(N)
    assert Nk == (16 if N == 12 and fn not in _RUNTIME_N else N)
    assert ints[n_at] == Nk
    D = 16
    assert shapes["A"] == (4, D, Nk)
    if fn in ("scan_forward", "scan_backward", "scan_fused_forward"):
        assert ints[n_at + 1] == tscan.scan_chunk(N)
    if fn in _RUNTIME_N:
        assert shapes["Bmat"] == shapes["Cmat"] == (1, 4, 12, N)
    else:
        assert shapes["wproj"] == (4, D, D + 2 * Nk)
    if fn == "scan_backward":
        NC = -(-12 // tscan.scan_chunk(N))
        assert shapes["h_bounds"] == (4, NC, N, D)
        assert ints[n_at + 2] == -(-D // 32)  # room for the channel tiles of gB, gC
    buffers = ptrs[y_at:y_at + (2 if fn == "scan_backward" else 1)]
    assert all((p is not None) == (Nk > 64) for p in buffers)


def test_recorder_launches_restore_the_counters():
    """The recorder launches, then a CPU call in the same process: the
    counters are where they were, and the CPU call launches nothing (the
    three ``test_mamba_block_op`` cases of ``test_torch_unified.py`` failed
    when a recorder launch had raised the ``mamba_block_forward`` count)."""
    before = _counters()
    for launch, lib, *_ in _LAUNCHES:
        with pytest.MonkeyPatch.context() as mp:
            _record(mp, launch, lib, 64)
            assert _counters() != before
    assert _counters() == before
    out = tunified.ss2d_mamba_block(*_mamba_raw(_scan_case(12), 12))
    assert torch.isfinite(out).all()
    assert _counters() == before


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
