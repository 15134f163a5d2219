"""The SS2D options of the port, ``PatchMerging2D`` and ``MambaBlock(dropout,
cross)``, against the JAX package on the CPU.

The JAX modules run with ``scan_impl="pallas_fused"`` (their Pallas kernels
in interpret mode), so that the JAX routing conditions themselves pick the
route: each case counts the ops both sides call (the fused block, the image
scan, the fused-projection scan and the two epilogue layouts) and holds the
port's counts to the JAX ones, then the outputs to each other.

- SS2D with ``use_bias``, ``dropout`` (eval), ``conv_bias=False``,
  ``d_conv`` 5, ``dt_rank``, ``forward_type="v0"``, on even and odd grids,
  with the gated residual and without it;
- ``step_size`` 3 on an even and an odd grid: the direction sequences'
  scan against the JAX ``_scan_core(merge=False)``; the merge raises
  ``TypeError`` on both sides;
- dropout in train mode, which cannot match JAX's draws: the share of zeros
  and the scale of the rest against the eval output, from a seeded
  generator;
- ``MambaBlock(cross=True)`` at C 128 (norm2 and ``CrossAttention``, never
  ``attn_block``) and ``MambaBlock(dropout)`` in eval mode;
- ``PatchMerging2D`` on an odd grid, with and without ``out_dim``.

Params: the JAX init (quick-compile options), adaLN perturbed, loaded into
the port strictly through ``from_jax_params``.  fp32; rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu.ops import scan_pallas as jsp
from founddiff_tpu.ops import ss2d_block as jblock
from founddiff_tpu.ops import ss2d_fused as jfused
from founddiff_tpu_torch.models import ss2d as tss2d
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import jit_quick, load_port, np_, perturb, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
C0, N = 16, 4

# the ops each side may call, JAX name -> the port's
ROUTE_OPS = {"ss2d_image_block": "ss2d_image_block", "selective_scan_image": "scan_image",
             "selective_scan_pallas_fused": "selective_scan_fused",
             "merge_ln_gate": "merge_ln_gate", "merge_ln_gate_split": "merge_ln_gate_split"}
JAX_MODULES = {"ss2d_image_block": jblock, "selective_scan_image": jsp,
               "selective_scan_pallas_fused": jsp, "merge_ln_gate": jfused,
               "merge_ln_gate_split": jfused}


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


@pytest.fixture
def calls(monkeypatch):
    """Counts of the route ops, {"jax": {...}, "port": {...}}, by JAX name."""
    seen = {"jax": {}, "port": {}}

    def count(side, module, attr, key):
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            seen[side][key] = seen[side].get(key, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(module, attr, wrapped)

    for jname, pname in ROUTE_OPS.items():
        count("jax", JAX_MODULES[jname], jname, jname)
        count("port", tss2d, pname, jname)
    return seen


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _inputs(seed, H, W, C=C0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    c = (rng.standard_normal((2, 1, 256)) * 0.1).astype(np.float32)
    gate = (rng.standard_normal((2, C)) * 0.3).astype(np.float32)
    return x, c, gate


def _port_ss2d(opts):
    names = {"ssm_ratio", "dt_rank", "d_conv", "conv_bias", "dropout", "use_bias",
             "step_size", "forward_type"}
    return tss2d.SS2D(C0, N, **{k: v for k, v in opts.items() if k in names})


# (options, H, W, gated, the JAX route expected: calls per forward)
SS2D_CASES = [
    (dict(use_bias=True), 8, 8, True, {"selective_scan_image": 1, "merge_ln_gate_split": 1}),
    (dict(dropout=0.1), 2, 2, True, {"selective_scan_image": 1, "merge_ln_gate_split": 1}),
    (dict(d_conv=5, conv_bias=False, dt_rank=3), 6, 10, True, {"ss2d_image_block": 1}),
    (dict(), 8, 8, False, {"selective_scan_image": 1, "merge_ln_gate_split": 1}),
    (dict(forward_type="v0"), 8, 8, True, {"selective_scan_pallas_fused": 1}),
    (dict(forward_type="v0", use_bias=True), 5, 7, False, {"selective_scan_pallas_fused": 1}),
    (dict(use_bias=True, dt_rank=5, d_conv=4), 5, 7, True, {"selective_scan_pallas_fused": 1}),
]


@pytest.mark.parametrize("opts,H,W,gated,route", SS2D_CASES,
                         ids=[f"{'-'.join(f'{k}{v}' for k, v in o.items()) or 'plain'}-{h}x{w}"
                              f"{'-gated' if g else ''}" for o, h, w, g, _ in SS2D_CASES])
def test_ss2d_options(opts, H, W, gated, route, calls):
    x, c, gate = _inputs(H * W, H, W)
    jm = jss2d.SS2D(d_model=C0, d_state=N, scan_impl="pallas_fused", **opts)
    kw = dict(gate=jnp.asarray(gate), residual=jnp.asarray(x)) if gated else {}
    params = jit_quick(lambda k, *a: jm.init(k, *a, **kw))(jax.random.PRNGKey(H + W),
                                                           jnp.asarray(x), jnp.asarray(c))
    params = _numpy(params["params"])
    calls["jax"].clear()
    want = jit_quick(lambda p, *a: jm.apply({"params": p}, *a, **kw))(
        params, jnp.asarray(x), jnp.asarray(c))
    port = load_port(_port_ss2d(opts), params)
    got = port(t_(x), t_(c), *((t_(gate), t_(x)) if gated else ()))
    assert calls["jax"] == route
    assert calls["port"] == route
    assert got.shape == want.shape == x.shape
    _close(got, want)
    sd = from_jax_params(params)
    assert ("in_proj.bias" in sd) == ("out_proj.bias" in sd) == opts.get("use_bias", False)
    assert ("conv2d.bias" in sd) == opts.get("conv_bias", True)
    assert sd["conv2d.weight"].shape[-1] == opts.get("d_conv", 3)


class _ScanCore(jss2d.SS2D):
    """The JAX SS2D's ``_scan_core(merge=False)`` of a given scan input:
    the [B, 4, L, D] sequences after the scan."""

    @nn.compact
    def __call__(self, xs):
        B, H, W, D = xs.shape
        R = self.dt_rank or -(-self.d_model // 16)
        return self._scan_core(xs, H, W, D, R, self.d_state, 4, merge=False)


@pytest.mark.parametrize("H,W", [(6, 6), (7, 5)])
def test_ss2d_step_3(H, W):
    """The direction sequences of efficient_scan(xs, 3) through the scan, as
    the JAX ``_scan_core(merge=False)`` computes them; the merge then fails
    on both sides: 4 directions fill a 2x2 block of each 3x3 cell."""
    x, c, _ = _inputs(H, H, W)
    D = 2 * C0
    xs = np.random.default_rng(H * W).standard_normal((2, H, W, D)).astype(np.float32)
    jm = _ScanCore(d_model=C0, d_state=N, step_size=3, scan_impl="pallas_fused")
    params = _numpy(jit_quick(jm.init)(jax.random.PRNGKey(1), jnp.asarray(xs))["params"])
    want = jit_quick(jm.apply)({"params": params}, jnp.asarray(xs))
    port = tss2d.SS2D(C0, N, step_size=3)
    port.load_state_dict(from_jax_params(params), strict=False)
    port.eval().requires_grad_(False)
    got = port.scan_core(t_(xs), merge=False)
    L = -(-H // 3) * -(-W // 3)
    assert got.shape == want.shape == (2, 4, L, D)
    _close(got, want)
    full = jss2d.SS2D(d_model=C0, d_state=N, step_size=3, scan_impl="pallas_fused")
    with pytest.raises(TypeError):
        full.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c))
    with pytest.raises(TypeError):
        port(t_(x), t_(c))


@pytest.mark.parametrize("where", ["ss2d", "cross_attention"])
def test_dropout_in_train_mode(where):
    """Dropout acts in train mode only: at p 0.3 the share of zeros of the
    dropped tensor is p (within 2% on 8,192 elements) and every other
    element is the eval value / (1 - p); two draws from one seed agree."""
    p = 0.3
    x, c, _ = _inputs(5, 16, 16)
    gen = torch.Generator().manual_seed(5)
    if where == "ss2d":
        mod = tss2d.SS2D(C0, N, dropout=p)
        args = (t_(x), t_(c))
    else:
        mod = tss2d.CrossAttention(32, context_dim=256)
        mod.to_out[1].p = p
        args = (t_(np.concatenate([x, x], -1)), t_(c))
    from founddiff_tpu_torch.factory import init_params

    init_params(mod, gen)
    mod.requires_grad_(False)
    want = mod.eval()(*args)
    mod.train()
    torch.manual_seed(11)
    got = mod(*args)
    torch.manual_seed(11)
    again = mod(*args)
    assert torch.equal(got, again)
    zeros = (got == 0) & (want != 0)
    share = float(zeros.float().mean())
    assert abs(share - p) < 0.02, share
    kept = ~zeros
    torch.testing.assert_close(got[kept], want[kept] / (1 - p), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cross,dropout", [(True, 0.0), (False, 0.2)])
def test_mamba_block_options(cross, dropout, calls, monkeypatch):
    """C 128 on an 8x8 grid: without cross the attention half would be
    ``attn_block``; with cross it is norm2 and CrossAttention on the content
    embedding on both sides.  Dropout in eval mode is the identity, and
    moves the SS2D off the folded route on both sides."""
    C, H, tdim = 128, 8, 64
    rng = np.random.default_rng(C)
    x = rng.standard_normal((2, H, H, C)).astype(np.float32)
    c = (rng.standard_normal((2, 1, 256)) * 0.1).astype(np.float32)
    t = rng.standard_normal((2, tdim)).astype(np.float32)
    if cross:
        monkeypatch.setattr(tss2d, "attn_block",
                            lambda *a, **k: pytest.fail("a cross block took attn_block"))
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, cross=cross, dropout=dropout,
                          scan_impl="pallas_fused")
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(0), x, c, t)["params"], seed=C)
    calls["jax"].clear()
    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    port = load_port(tss2d.MambaBlock(C, N, time_dim=tdim, cross=cross, dropout=dropout),
                     params)
    got = port(t_(x), t_(c), t_(t))
    _close(got, want)
    assert ("attn_blk.to_out.0.weight" in from_jax_params(params)) == cross
    route = {"ss2d_image_block": 1} if dropout == 0 else {"selective_scan_image": 1,
                                                           "merge_ln_gate_split": 1}
    assert calls["jax"] == route


@pytest.mark.parametrize("out_dim", [-1, 24])
def test_patch_merging(out_dim):
    from founddiff_tpu.models.ss2d import PatchMerging2D as JPatchMerging2D

    x = np.random.default_rng(7).standard_normal((2, 7, 9, 8)).astype(np.float32)
    jm = JPatchMerging2D(dim=8, out_dim=out_dim)
    params = _numpy(jit_quick(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    rs = np.random.default_rng(8)
    params["norm"] = {k: (v + rs.standard_normal(v.shape) * 0.1).astype(np.float32)
                      for k, v in params["norm"].items()}
    want = jit_quick(jm.apply)({"params": params}, jnp.asarray(x))
    port = load_port(tss2d.PatchMerging2D(8, out_dim), params)
    got = port(t_(x))
    assert got.shape == want.shape == (2, 4, 5, out_dim if out_dim > 0 else 16)
    _close(got, want)


def test_scan_layouts_and_exports():
    """``cross_scan_v0`` / ``cross_merge_v0`` against the JAX layouts, the
    step-by-step ``selective_scan_ref`` (from an initial state, with the last
    state) against the JAX reference, ``flops_selective_scan`` and
    ``slice_metrics``; and the names the JAX ``__init__``s export."""
    import founddiff_tpu.models as jmodels
    import founddiff_tpu.ops as jops
    import founddiff_tpu_torch.models as tmodels
    import founddiff_tpu_torch.ops as tops
    import importlib

    from founddiff_tpu.ops import metrics as jmetrics

    # the module: the package exports a function of its name
    jscan = importlib.import_module("founddiff_tpu.ops.selective_scan")

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    seq = tops.cross_scan_v0(t_(x))
    _close(seq, jscan.cross_scan_v0(jnp.asarray(x)))
    _close(tops.cross_merge_v0(seq, 5, 7), jscan.cross_merge_v0(jnp.asarray(np_(seq)), 5, 7))
    B, K, L, D, Ns = 2, 4, 9, 6, 3
    u, delta = (rng.standard_normal((B, K, L, D)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.standard_normal((K, D, Ns))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, K, L, Ns)).astype(np.float32) for _ in range(2))
    Ds, bias = (rng.standard_normal((K, D)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, K, D, Ns)).astype(np.float32)
    args = (u, delta, A, Bm, Cm, Ds, bias)
    want = jscan.selective_scan_ref(*map(jnp.asarray, args), h_init=jnp.asarray(h0),
                                    return_last_state=True)
    got = tops.selective_scan_ref(*map(t_, args), h_init=t_(h0), return_last_state=True)
    for g, w in zip(got, want):
        _close(g, w)
    assert tops.flops_selective_scan(2, 100, 64, 4, with_Z=True) == \
        jscan.flops_selective_scan(2, 100, 64, 4, with_Z=True)
    a = rng.random((2, 16, 16, 1)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    want = jmetrics.slice_metrics(jnp.asarray(a), jnp.asarray(b))
    got = tops.slice_metrics(t_(a), t_(b))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    # every JAX export but the TPU kernel entry selective_scan_pallas and the
    # two names that are the port's modules
    assert set(jmodels.__all__) - set(tmodels.__all__) == set()
    assert set(jops.__all__) - set(tops.__all__) == {"flash_attention", "selective_scan",
                                                     "selective_scan_pallas"}
