"""The kernel-op protocol of ``founddiff_tpu_torch/ops/remat.py`` and the scan
weight operands of ``ops/scan.py``, on the CPU.

- each of the seven ops built by ``remat_op`` (``layer_norm``,
  ``layer_norm_modulated``, ``attn_block``, ``ss2d_image_block``,
  ``ss2d_mamba_block``, ``merge_ln_gate`` / ``merge_ln_gate_split``,
  ``group_norm_silu``'s kernel route) at micro shapes: the direct call (no
  gradient recorded) and the recorded call give the same forward bits; the
  recorded call's gradients equal ``torch.autograd.grad`` through the op's
  composition; autograd names its node ``<X>FnBackward``; under
  ``trace.recording()`` the recorded call runs in the
  ``kernel.<X>Fn.forward`` and ``.backward`` spans and the direct call in
  neither;
- ``scan_weights``: the kernels' [4, D, D+2Np] projection is delta | B | C
  with zero B and C columns up to ``kernel_states(N)`` and A padded with -1,
  bit for bit, at N = 4, 12 and 64; the folded weights are
  ``_derive_weights`` at the io dtype, derived once per parameter version
  when autograd records nothing and with their history when it does.
"""

import pytest
import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops import attn_block as tattn
from founddiff_tpu_torch.ops import experimental_unified as tunified
from founddiff_tpu_torch.ops import groupnorm as tgn
from founddiff_tpu_torch.ops import norm as tnorm
from founddiff_tpu_torch.ops import scan as tscan
from founddiff_tpu_torch.ops import ss2d_block as tblock
from founddiff_tpu_torch.ops import ss2d_fused as tfused
from founddiff_tpu_torch.utils import trace
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

B, H, W, C0, R, N = 2, 4, 6, 16, 2, 4
D = 2 * C0


def _n(g, *shape, scale=0.3):
    return torch.randn(shape, generator=g) * scale


def _ln(g):
    x, scale, bias = _n(g, B, 5, C0, scale=1.0), _n(g, C0) + 1, _n(g, C0)
    return ((x, scale, bias), tnorm.layer_norm,
            lambda x, s, b: tnorm.layer_norm_two_pass(x, s, b, 1e-5))


def _ln_mod(g):
    args = (_n(g, B, 5, C0, scale=1.0), _n(g, C0) + 1, _n(g, C0), _n(g, B, C0), _n(g, B, C0))
    return (args, tnorm.layer_norm_modulated,
            lambda x, s, b, ms, mt: tnorm._ln_mod(x, s, b, ms, mt, 1e-5))


def _attn(g):
    C = 64
    args = (_n(g, B, 8, 8, C, scale=1.0), _n(g, B, C), _n(g, B, C), _n(g, B, C),
            _n(g, 3 * C, C, 1, 1, scale=0.1), _n(g, 3 * C, 1, 3, 3), _n(g, 2, 1, 1) + 1,
            _n(g, C, C, 1, 1, scale=0.1))
    return (args, lambda *a: tattn.attn_block(*a, heads=2),
            lambda *a: tattn.attn_block_plain(*a, 2, 1e-6))


def _block(g):
    args = (_n(g, B, H, W, C0), F.silu(_n(g, B, H, W, D)), _n(g, B, H, W, C0), _n(g, C0, D),
            _n(g, 4, R + 2 * N, D), _n(g, 4, D, R), -torch.rand(4, D, N, generator=g) - 0.1,
            _n(g, 4, D), _n(g, 4, D), _n(g, D) + 1, _n(g, D), _n(g, B, D), _n(g, D, C0),
            _n(g, B, C0))

    def compose(x1, xs, xr, wz, xw, dtw, *rest):
        w = tscan.scan_weights(xs.dtype, xw, dtw, dt_rank=R, d_state=N)
        return tblock.ss2d_compose(x1, xs, xr, wz, *w, *rest, 1e-5)

    return args, lambda *a: tblock.ss2d_image_block(*a, dt_rank=R, d_state=N), compose


def _mamba(g):
    args = (_n(g, B, H, W, C0, scale=1.0), _n(g, C0) + 1, _n(g, C0), _n(g, B, C0),
            _n(g, B, C0), _n(g, 2 * D, C0), _n(g, D, 1, 3, 3), _n(g, D), _n(g, 4, R + 2 * N, D),
            _n(g, 4, D, R), -torch.rand(4, D, N, generator=g) - 0.1, _n(g, 4, D), _n(g, 4, D),
            _n(g, D) + 1, _n(g, D), _n(g, B, D), _n(g, C0, D), _n(g, B, C0))
    kw = dict(d_inner=D, dt_rank=R, d_state=N)

    def compose(*a):
        return tunified.mamba_compose(*tunified._split_args(*a, **kw), 1e-5, 1e-5)

    return args, lambda *a: tunified.ss2d_mamba_block(*a, **kw), compose


def _fold(g, C=C0, Co=8):
    return _n(g, C, Co), _n(g, B, Co), _n(g, B, H, W, Co)


def _merge(g):
    L = (H // 2) * (W // 2)
    args = (_n(g, B, 4, L, C0), _n(g, B, H, W, C0), _n(g, C0) + 1, _n(g, C0), _n(g, B, C0),
            *_fold(g))
    kw = dict(H=H, W=W, gate_silu=True)

    def op(ys, z, s, b, loc, pw, gate, rx):
        return tfused.merge_ln_gate(ys, z, s, b, loc, proj_w=pw, gate=gate, residual_x=rx, **kw)

    def compose(ys, z, s, b, loc, pw, gate, rx):
        return tfused.merge_ln_gate_plain(ys, z, s, b, loc, proj_w=pw, gate=gate,
                                          residual_x=rx, **kw)

    return args, op, compose


def _merge_split(g):
    L = (H // 2) * (W // 2)
    args = (_n(g, B, 2, L, C0), _n(g, B, 2, L, C0), _n(g, B, H, W, C0), _n(g, C0) + 1,
            _n(g, C0), None)
    kw = dict(H=H, W=W, gate_silu=True)
    return (args, lambda *a: tfused.merge_ln_gate_split(*a, **kw),
            lambda *a: tfused.merge_ln_gate_split_plain(*a, **kw))


def _group_norm(g):
    args = (_n(g, B, H, W, C0, scale=1.0), _n(g, C0) + 1, _n(g, C0), _n(g, B, H, W, C0),
            _n(g, B, C0), _n(g, B, C0))
    return (args, lambda x, s, b, r, ms, mt: tgn.group_norm_silu(x, s, b, r, (ms, mt), groups=4),
            lambda *a: tgn.gn_silu_composed(*a, 4, 1e-5))


OPS = {"_LnFn": _ln, "_LnModFn": _ln_mod, "_AttnBlockFn": _attn, "_SS2DBlockFn": _block,
       "_MambaBlockFn": _mamba, "_EpilogueFn": _merge, "_EpilogueFn-split": _merge_split,
       "GroupNormSiLUFn": _group_norm}


def _node_names(out, depth=3):
    names, frontier = set(), [out.grad_fn]
    for _ in range(depth):
        frontier = [f for f in frontier if f is not None]
        names.update(type(f).__name__ for f in frontier)
        frontier = [n for f in frontier for n, _ in f.next_functions]
    return names


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("case", list(OPS))
def test_remat_op_paths(monkeypatch, case):
    monkeypatch.setenv("FOUNDDIFF_GN", "pallas")
    name = case.split("-")[0]
    args, op, compose = OPS[case](torch.Generator().manual_seed(len(case)))
    with torch.no_grad(), trace.recording() as direct_rec:
        direct = op(*args)
    leaves = [a.clone().requires_grad_() if a is not None else None for a in args]
    wrt = [a for a in leaves if a is not None]
    with trace.recording() as rec:
        out = op(*leaves)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
        got = torch.autograd.grad(out, wrt, cot)
    assert torch.equal(_bits(out), _bits(direct))
    assert f"{name}Backward" in _node_names(out)
    spans = [s.name for s in rec.spans]
    assert f"kernel.{name}.forward" in spans and f"kernel.{name}.backward" in spans
    assert not any(s.name.startswith(f"kernel.{name}.") for s in direct_rec.spans)
    ref = [a.clone().requires_grad_() if a is not None else None for a in args]
    want = torch.autograd.grad(compose(*ref), [a for a in ref if a is not None], cot)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda m: f"input {i}: {m}")


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 12, 64])
def test_scan_weights_projection(io, n):
    g = torch.Generator().manual_seed(n)
    Dn = 16
    w_delta, w_b, w_c = _n(g, 4, Dn, Dn), _n(g, 4, Dn, n), _n(g, 4, Dn, n)
    A, Ds, bias = -torch.rand(4, Dn, n, generator=g) - 0.1, _n(g, 4, Dn), _n(g, 4, Dn)
    wproj, A32, Ds32, bias32 = tscan.scan_weights(io, w_delta, w_b, w_c, A=A, Dskip=Ds,
                                                  delta_bias=bias)
    Np = tscan.kernel_states(n)
    pad = (0, Np - n)
    want = torch.cat([w_delta, F.pad(w_b, pad), F.pad(w_c, pad)], dim=-1).to(io)
    assert wproj.dtype == io and wproj.shape == (4, Dn, Dn + 2 * Np) and wproj.is_contiguous()
    assert torch.equal(wproj.view(torch.uint8), want.view(torch.uint8))
    assert A32.shape == (4, Dn, Np) and torch.equal(A32[..., :n], A)
    assert bool((A32[..., n:] == -1).all())
    assert torch.equal(Ds32, Ds) and torch.equal(bias32, bias)
    _, A_run, _, _ = tscan.scan_weights(io, A=A, Dskip=Ds, delta_bias=bias)
    assert A_run.shape == (4, Dn, n)  # the runtime-N kernels take A as it is


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_scan_weights_fold(io):
    g = torch.Generator().manual_seed(3)
    xw = torch.nn.Parameter(_n(g, 4, R + 2 * N, D))
    dtw = torch.nn.Parameter(_n(g, 4, D, R))
    want = [w.to(io) for w in tscan._derive_weights(xw, dtw, R, N)]
    recorded = tscan.scan_weights(io, xw, dtw, dt_rank=R, d_state=N)
    assert all(w.grad_fn is not None for w in recorded)
    with torch.no_grad():
        first = tscan.scan_weights(io, xw, dtw, dt_rank=R, d_state=N)
        assert tscan.scan_weights(io, xw, dtw, dt_rank=R, d_state=N) is first
    for a, b, c in zip(recorded, first, want):
        assert torch.equal(a.detach(), b) and torch.equal(b, c.detach())
    with torch.no_grad():
        xw.mul_(-0.5)
        moved = tscan.scan_weights(io, xw, dtw, dt_rank=R, d_state=N)
    assert moved is not first
    for a, b in zip(moved, tscan._derive_weights(xw, dtw, R, N)):
        assert torch.equal(a, b.detach().to(io))
