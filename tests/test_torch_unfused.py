"""The port's unfused and epilogue SS2D routes (CPU, plain versions) against
the JAX package.

JAX runs its Pallas kernels in interpret mode on the CPU, as its own tests
run them: ``layer_norm`` (``_ln_kernel``), ``selective_scan_pallas_fused``
(``_scan_kernel_fused`` forward, ``_ssf_bwd`` through ``_scan_bwd_kernel``
backward) and ``merge_ln_gate`` / ``merge_ln_gate_split``
(``_epilogue_kernel`` forward, remat backward), and a micro FoundDiff whose
deepest grid is odd (dim 16 x (1,) at 5^2: 2-step DDIM and a train step)
on its TPU routing
(``scan_impl="pallas_fused"``).  Inputs are made with numpy from a seed.
fp32 throughout; rtol 1e-3 / atol 1e-4 on values and gradients, except the
2-step DDIM image (atol 2e-3, as ``tests/test_torch_slice.py``: two full
UNet passes and the clip to [-1, 1] compound the fp32 reassociation) and
the UNet's parameter gradients (per parameter ||g_port - g_jax|| <= 1e-3
||g_jax|| + 1e-6, as ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import founddiff_tpu.ops.scan_pallas as jsp
from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.ops.norm_pallas import layer_norm as j_layer_norm
from founddiff_tpu.ops.ss2d_fused import merge_ln_gate as j_mlg
from founddiff_tpu.ops.ss2d_fused import merge_ln_gate_split as j_mlg_split
from founddiff_tpu.pipeline import make_hoisted_sampler as j_make_sampler
from founddiff_tpu.utils.torch_convert import convert_denoiser_params
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.ops import scan as tscan
from founddiff_tpu_torch.ops import ss2d_fused as tfused
from founddiff_tpu_torch.ops.norm import layer_norm as t_layer_norm
from founddiff_tpu_torch.pipeline import make_hoisted_sampler as t_make_sampler
from founddiff_tpu_torch.utils import trace
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, jit_quick, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4


def _close(got, want, err_msg="", atol=ATOL):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=atol,
                               err_msg=err_msg)


def _f(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _grads_both(j_fn, t_fn, args, seed):
    """Values and the gradients of sum(out * w) for a seeded w, through the
    JAX function and the port's, with respect to every array in ``args``."""
    shape = jax.eval_shape(j_fn, *map(jnp.asarray, args)).shape
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)

    def value_and_vjp(*a):
        y, vjp = jax.vjp(j_fn, *a)
        return y, vjp(jnp.asarray(w))

    y, g_j = jit_quick(value_and_vjp)(*map(jnp.asarray, args))
    xs = [t_(a).requires_grad_() for a in args]
    y_t = t_fn(*xs)
    g_t = torch.autograd.grad(y_t, xs, t_(w))
    return y, y_t, g_j, g_t


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rs = np.random.RandomState(1 + affine)
    x = _f(rs, 3, 5, 40) + 0.3
    args = [x] + ([_f(rs, 40, scale=0.1) + 1, _f(rs, 40, scale=0.1)] if affine else [])
    if affine:
        j_fn = lambda x, g, b: j_layer_norm(x, g, b, 1e-5)
        t_fn = lambda x, g, b: t_layer_norm(x, g, b, 1e-5)
    else:
        j_fn = lambda x: j_layer_norm(x, None, None, 1e-6)
        t_fn = lambda x: t_layer_norm(x, None, None, 1e-6)
    y, y_t, g_j, g_t = _grads_both(j_fn, t_fn, args, seed=3)
    _close(y_t, y)
    for name, a, b in zip(("x", "scale", "bias"), g_t, g_j):
        _close(a, b, name)


def _fused_inputs(B, L, D, N, seed):
    rs = np.random.RandomState(seed)
    xs = _f(rs, B, 4, L, D)
    w_delta = _f(rs, 4, D, D, scale=D ** -0.5)
    w_b, w_c = _f(rs, 4, D, N, scale=D ** -0.5), _f(rs, 4, D, N, scale=D ** -0.5)
    A = -np.abs(_f(rs, 4, D, N)) - 0.1
    return xs, w_delta, w_b, w_c, A, _f(rs, 4, D), _f(rs, 4, D, scale=0.1) - 2.0


def test_selective_scan_fused_ragged_l():
    """L = 37: the port's chunk of 16 steps (N = 16) ends the last chunk at
    L, the JAX kernel masks its padded steps; forward and the seven
    gradients of the custom_vjp (xs, the three folded weights, A, Dskip,
    delta_bias)."""
    args = _fused_inputs(2, 37, 24, 16, seed=5)
    j_fn = lambda *a: jsp._selective_scan_pallas_fused(*a, True)
    y, y_t, g_j, g_t = _grads_both(j_fn, tscan.SelectiveScanFusedFn.apply, args, seed=6)
    _close(y_t, y)
    for name, a, b in zip(("xs", "w_delta", "w_b", "w_c", "A", "Dskip", "delta_bias"), g_t,
                          g_j):
        _close(a, b, name)


def test_selective_scan_fused_from_unfolded_weights():
    """``selective_scan_fused`` folds the dt low rank as the JAX op does."""
    rs = np.random.RandomState(7)
    B, L, D, N, R = 1, 20, 32, 8, 2
    xs = _f(rs, B, 4, L, D)
    xw, dtw = _f(rs, 4, R + 2 * N, D, scale=D ** -0.5), _f(rs, 4, D, R, scale=R ** -0.5)
    A, Ds, bias = -np.abs(_f(rs, 4, D, N)) - 0.1, _f(rs, 4, D), _f(rs, 4, D, scale=0.1) - 2
    want = jsp.selective_scan_pallas_fused(*map(jnp.asarray, (xs, xw, dtw, A, Ds, bias)),
                                           dt_rank=R, d_state=N)
    got = tscan.selective_scan_fused(*map(t_, (xs, xw, dtw, A, Ds, bias)), dt_rank=R,
                                     d_state=N)
    _close(got, want)


def test_scan_fused_h_bounds_are_scan_forwards():
    """The fused scan's h_bounds are ``scan_forward``'s on the same delta/B/C
    (the layout and chunking ``scan_backward`` reads), and so is y."""
    xs, w_delta, w_b, w_c, A, Ds, bias = map(t_, _fused_inputs(2, 45, 16, 32, seed=8))
    y, hb = tscan.scan_fused_forward(xs, w_delta, w_b, w_c, A, Ds, bias)
    y_ref, hb_ref = tscan.scan_forward(xs, xs @ w_delta[None], A, xs @ w_b[None],
                                       xs @ w_c[None], Ds, bias)
    assert hb.shape == (8, -(-45 // tscan.scan_chunk(32)), 32, 16)
    _close(hb, hb_ref)
    _close(y, y_ref)


# (local, gate_silu, fold): each flag on and off
FLAGS = [(True, True, True), (False, True, False), (True, False, False), (False, False, True)]


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("local,gate_silu,fold", FLAGS)
def test_merge_ln_gate(split, local, gate_silu, fold):
    B, H, W, C, Co = 2, 4, 6, 16, 8
    L = (H // 2) * (W // 2)
    rs = np.random.RandomState(10 + 8 * split + 4 * local + 2 * gate_silu + fold)
    ys = _f(rs, B, 4, L, C)
    args = [ys[:, 0::2], ys[:, 1::2]] if split else [ys]
    args += [_f(rs, B, H, W, C), _f(rs, C, scale=0.1) + 1, _f(rs, C, scale=0.1)]
    names = ["rows", "cols"] if split else ["ys"]
    names += ["z", "scale", "bias"]
    if local:
        args.append(_f(rs, B, C, scale=0.2))
        names.append("local")
    if fold:
        args += [_f(rs, C, Co, scale=C ** -0.5), _f(rs, B, Co, scale=0.3), _f(rs, B, H, W, Co)]
        names += ["proj_w", "gate", "residual_x"]
    n_ys = 2 if split else 1

    def call(fn, arrays):
        ys_args, (z, scale, bias, *rest) = arrays[:n_ys], arrays[n_ys:]
        loc = rest.pop(0) if local else None
        kw = dict(zip(("proj_w", "gate", "residual_x"), rest))
        return fn(*ys_args, z, scale, bias, loc, H=H, W=W, eps=1e-5, gate_silu=gate_silu, **kw)

    j_fn = lambda *a: call(j_mlg_split if split else j_mlg, a)
    t_fn = lambda *a: call(tfused.merge_ln_gate_split if split else tfused.merge_ln_gate, a)
    y, y_t, g_j, g_t = _grads_both(j_fn, t_fn, args, seed=11)
    _close(y_t, y)
    for name, a, b in zip(names, g_t, g_j):
        _close(a, b, name)


# --- the kernels' host-side planning -------------------------------------------


class _Launch:
    """A stand-in for a kernel's C function: records its arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


def _stand_in(monkeypatch):
    """Every kernel call goes to one recorder; the launch counters are
    restored from a snapshot of the registry when ``monkeypatch`` undoes its
    patches."""
    rec = _Launch()
    monkeypatch.setattr(trace, "_counts", dict(trace._counts))
    monkeypatch.setattr(tscan._build, "kernel", lambda *a: rec)
    monkeypatch.setattr(tscan._build, "stream", lambda: 0)
    return rec


@pytest.mark.parametrize("N", [4, 8, 12, 16, 32, 64, 128])
def test_fused_pass_chunk(N):
    """The fused-projection kernel's passes run the largest multiple of the
    h_bounds chunk at most the image kernel's chunk (at least the h_bounds
    chunk), so pass 2 meets every h_bounds boundary: 32 steps at N = 32
    (four of ``scan_backward``'s 8)."""
    chunk, Np = tscan.scan_chunk(N), tscan.kernel_states(N)
    TC, img = tscan._fused_chunk(chunk, Np), tscan._image_chunk(Np)
    assert TC % chunk == 0 and chunk <= TC <= max(chunk, img) and TC + chunk > img
    if N == 32:
        assert (chunk, TC) == (8, 32)


@pytest.mark.parametrize("bounds", [True, False])
def test_scan_fused_launch_arguments(monkeypatch, bounds):
    """What the wrapper hands the kernel at L = 45, N = 32: G, L, D, N, the
    h_bounds chunk and the passes' chunk; h_bounds [G, 6, N, D] or, without
    them, a null pointer and None."""
    rec = _stand_in(monkeypatch)
    xs, w_delta, w_b, w_c, A, Ds, bias = map(t_, _fused_inputs(2, 45, 16, 32, seed=9))
    y, hb = tscan._scan_fused_cuda(xs, w_delta, w_b, w_c, A, Ds, bias, tscan.scan_chunk(32),
                                   bounds)
    ptrs, ints = rec.args[:11], rec.args[11:]
    assert ints == (8, 45, 16, 32, 8, 32, 0, 0)
    assert y.shape == xs.shape
    assert (ptrs[6] is None) == (not bounds) and ptrs[9] is None  # no yacc at N <= 64
    assert hb is None if not bounds else hb.shape == (8, 6, 32, 16)


@pytest.mark.parametrize("P,C,Co,io_size,plan", [
    (4, 1024, 512, 2, 1), (4, 1024, 512, 4, 1), (16, 1024, 512, 4, 1), (4, 512, 256, 2, 1),
    (64, 1024, 512, 4, 1), (65, 128, 64, 4, 2), (129600, 128, 64, 2, 2),
    (32400, 256, 128, 4, 2), (4, 2048, 1024, 4, 0), (4, 2048, 1024, 2, 1)])
def test_fold_plan(P, C, Co, io_size, plan):
    """The epilogue fold's tiling: few pixels (the 2x2 grids of a 16^2 slice
    at bs1 to bs4, up to 64) on 16 x 16 tiles with K split over the warps,
    many on 64 x 64 tiles, both where og and the weight slice fit a block's
    227 KB of shared memory; fp32 at C 2048 does not, and takes two
    launches."""
    got, smem = tfused._fold_plan(P, C, Co, io_size)
    assert got == plan
    assert (smem <= 227 * 1024) == (plan != 0)


@pytest.mark.parametrize("C,fold,plan", [(1024, True, 1), (2048, True, 0), (64, False, 0)])
def test_epilogue_launch_arguments(monkeypatch, C, fold, plan):
    """fp32 at a 2x2 grid: the plan the wrapper hands the kernel, and the og
    scratch only for the two-launch form."""
    rec = _stand_in(monkeypatch)
    B, H, W, Co = 1, 2, 2, 64
    rs = np.random.RandomState(C)
    f = lambda *s: t_(_f(rs, *s))
    kw = dict(proj_w=f(C, Co), gate=f(B, Co), residual_x=f(B, H, W, Co)) if fold else {}
    out = tfused._epilogue_cuda(f(B, 2, 1, C), f(B, 2, 1, C), f(B, H, W, C), f(C), f(C), None,
                                kw.get("proj_w"), kw.get("gate"), kw.get("residual_x"), H, W,
                                1e-5, True)
    assert out.shape == (B, H, W, Co if fold else C)
    ptrs, ints = rec.args[:13], rec.args[13:]
    assert ints[9:12] == (int(fold), plan, 0)
    assert (ptrs[12] is not None) == (fold and plan == 0)


# --- a micro FoundDiff whose deepest grid is odd ------------------------------

# dim 16 x (1,) at 5^2: every MambaBlock on the odd grid, so on the unfused
# route (a two-level model at 10^2 traces its JAX programs for three times as
# long; the stride-2 resampling around an odd grid runs in chip_smoke.py's
# 360^2 phases)
MULTS, SIZE = (1,), 5


def _config():
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = 16, MULTS
    cfg.diffusion.image_size = SIZE
    return cfg


@pytest.fixture(scope="module")
def micro():
    """The micro JAX model, its diffusion and its params: the port's seeded
    init carried into the JAX tree by the JAX converter (the tree's shapes
    from ``eval_shape``, which compiles nothing), adaLN and prompt
    perturbed."""
    jm = JFoundDiff(dim=16, dim_mults=MULTS, scan_impl="pallas_fused",
                    clip_overrides=MICRO_CLIP)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), x0, time0)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, model = build(_config(), device="cpu", seed=3, clip_overrides=MICRO_CLIP)
    state = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    params, _, missing = convert_denoiser_params(
        state, template, num_res=len(MULTS), clip_vision_layers=(1, 1, 1, 1),
        clip_transformer_layers=2)
    assert missing == []
    params = perturb(params, seed=3)
    jd = JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s),
                    image_size=SIZE, timesteps=1000, sampling_timesteps=2, loss_type="l2",
                    objective="pred_res", condition=True, sum_scale=0.01,
                    test_res_or_noise="res")
    return jm, jd, params


def _port(params, train=False):
    diffusion, model = build(_config(), device="cpu", clip_overrides=MICRO_CLIP, train=train)
    model.load_state_dict(from_jax_params(params), strict=True)
    return diffusion, model


def _x01(seed, b=2):
    return np.random.default_rng(seed).random((b, SIZE, SIZE, 1)).astype(np.float32)


def test_micro_founddiff_odd_grid_two_step_ddim(micro):
    jm, jd, params = micro
    diffusion, model = _port(params)
    model.eval().requires_grad_(False)
    x01 = _x01(14)
    rng = jax.random.PRNGKey(6)
    want = jit_quick(j_make_sampler(jm, jd))(params, rng, jnp.asarray(x01))
    noise = jax.random.normal(jax.random.split(rng)[1], x01.shape)
    got = t_make_sampler(model, diffusion)(t_(x01), noise=t_(noise))
    assert got.shape == x01.shape and torch.isfinite(got).all()
    _close(got, want, atol=2e-3)


def test_micro_founddiff_odd_grid_train_step(micro):
    """One microbatch's loss and the gradient of every trainable parameter,
    the noise and t drawn from the JAX package's own keys."""
    jm, jd, params = micro
    imgs = [_x01(7), _x01(8)]
    rng = jax.random.PRNGKey(9)
    loss_j, grads_j = jit_quick(jax.value_and_grad(
        lambda p: sum(jd.loss(p, rng, [jnp.asarray(i) for i in imgs]))))(params)
    diffusion, model = _port(params, train=True)
    rng_t, t_rng = jax.random.split(rng)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 1000))).long()
    noise = t_(jax.random.normal(jax.random.split(rng_t, 4)[1], imgs[0].shape))
    loss_t = sum(diffusion.loss([t_(i) for i in imgs], t=t, noise=noise))
    _close(loss_t, loss_j)
    loss_t.backward()
    want = from_jax_params(grads_j)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:  # the frozen tower
            continue
        err = float((p.grad - want[name]).norm())
        assert err <= 1e-3 * float(want[name].norm()) + 1e-6, (name, err)
        checked += 1
    assert checked == len(want) - sum(".dose_encoder." in n for n in want)
