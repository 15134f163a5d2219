"""The kernel wrappers' host path, on CPU tensors.

Weight operands are derived once per parameter version
(``founddiff_tpu_torch/ops/_cache.py``): an in-place update (optimizer step,
EMA, ``load_state_dict``) or a ``.data`` swap makes the next call see the
new value.  Without autograd the wrappers skip their Function; with it they
give the same values.  ctypes functions are typed once.  Values are compared
exactly: the cached and the fresh paths run the same plain arithmetic.
"""

import ctypes
import gc

import pytest
import torch

from founddiff_tpu_torch.models.ss2d import SS2D
from founddiff_tpu_torch.ops import _build, _cache
from founddiff_tpu_torch.ops import norm as norm_mod
from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod


def _g(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("update", ["in_place", "load_state_dict", "data_swap"])
def test_derived_value_follows_the_parameter(update):
    lin = torch.nn.Linear(8, 4).to(torch.bfloat16)
    w = lin.weight
    first = _cache.f32(w)
    assert _cache.f32(w) is first  # a hit
    assert torch.equal(first, w.detach().float())
    new = torch.randn(4, 8, generator=_g(1)).to(torch.bfloat16)
    with torch.no_grad():
        if update == "in_place":
            w.copy_(new)
        elif update == "load_state_dict":
            lin.load_state_dict({"weight": new, "bias": lin.bias.detach()})
        else:
            w.data = new.clone()
    again = _cache.f32(w)
    assert again is not first and torch.equal(again, new.float())


def test_views_of_one_parameter_keep_their_own_values():
    w = torch.nn.Parameter(torch.randn(6, 4, generator=_g(2)).to(torch.bfloat16))
    top, bottom = _cache.f32(w[:3]), _cache.f32(w[3:])
    assert torch.equal(top, w[:3].float()) and torch.equal(bottom, w[3:].float())
    assert _cache.f32(w[:3]) is top and _cache.f32(w[3:]) is bottom


def test_derived_values_go_with_their_tensor():
    w = torch.randn(5, generator=_g(3)).to(torch.bfloat16)
    _cache.f32(w)
    gc.collect()  # entries of tensors that earlier tests left in reference cycles go first
    n = len(_cache._STORE)
    del w
    gc.collect()
    assert len(_cache._STORE) == n - 1


def test_activation_sources_are_not_kept():
    """A first source with autograd history (an operand formed under a
    recorded call) is made anew at each call and leaves no entry; a leaf
    parameter, or a view of one, is derived once."""
    w = torch.nn.Parameter(torch.randn(4, 8, generator=_g(9)))
    made = []
    make = lambda: made.append(1) or len(made)
    act = w * 2.0
    gc.collect()
    n = len(_cache._STORE)
    assert [_cache.derived("t", (act,), make) for _ in range(2)] == [1, 2]
    assert len(_cache._STORE) == n
    assert [_cache.derived("t", (w.t(),), make) for _ in range(2)] == [3, 3]
    assert len(_cache._STORE) == n + 1


def _block_args(seed, B=2, H=6, W=8, C0=16, N=4):
    g = _g(seed)
    D, R = 2 * C0, 1
    n = lambda *s: torch.randn(s, generator=g) * 0.3
    return dict(x1=n(B, H, W, C0), xs_conv=torch.nn.functional.silu(n(B, H, W, D)),
                x_raw=n(B, H, W, C0), w_z=n(C0, D),
                x_proj_weight=torch.nn.Parameter(n(4, R + 2 * N, D)),
                dt_projs_weight=n(4, D, R), A=-torch.rand(4, D, N, generator=g) - 0.1,
                Dskip=n(4, D), delta_bias=n(4, D), ln_g=n(D) + 1, ln_b=n(D),
                local=n(B, D), proj_w=n(D, C0), gate=n(B, C0), dt_rank=R, d_state=N)


def test_ss2d_image_block_sees_an_in_place_update():
    """The no-grad path caches the folded projections; after an update of
    x_proj_weight the next call equals the plain version on the new value."""
    args = _block_args(4)
    with torch.no_grad():
        first = ss2d_mod.ss2d_image_block(**args)
        assert torch.equal(first, ss2d_mod.ss2d_image_block_plain(**args))
        assert torch.equal(ss2d_mod.ss2d_image_block(**args), first)
        args["x_proj_weight"].mul_(-0.5)
        second = ss2d_mod.ss2d_image_block(**args)
    assert not torch.equal(second, first)
    assert torch.equal(second, ss2d_mod.ss2d_image_block_plain(**args))


def test_ss2d_image_block_paths_agree():
    """With autograd (the Function) and without (the direct call)."""
    args = _block_args(5)
    with torch.no_grad():
        direct = ss2d_mod.ss2d_image_block(**args)
    recorded = ss2d_mod.ss2d_image_block(**args)
    assert recorded.requires_grad and torch.equal(recorded.detach(), direct)


def test_ss2d_module_caches_A_per_version():
    m = SS2D(16, 4).requires_grad_(False)
    torch.nn.init.normal_(m.A_logs, generator=_g(6))
    a = m.A()
    assert m.A() is a and torch.equal(a, -torch.exp(m.A_logs).reshape(4, 32, 4))
    m.A_logs.add_(0.5)
    assert torch.equal(m.A(), -torch.exp(m.A_logs).reshape(4, 32, 4))
    m.requires_grad_(True)
    assert m.A().requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norms_agree_with_and_without_autograd(dtype):
    g = _g(7)
    x = torch.randn(2, 5, 24, generator=g).to(dtype)
    scale = torch.nn.Parameter(torch.randn(24, generator=g).to(dtype))
    bias = torch.nn.Parameter(torch.randn(24, generator=g).to(dtype))
    mod = torch.randn(2, 6 * 24, generator=g)
    ms, mt = mod.chunk(6, dim=-1)[:2]
    for fn, a in ((norm_mod.layer_norm, (x, scale, bias)),
                  (norm_mod.layer_norm_modulated, (x, scale, bias, ms, mt))):
        recorded = fn(*a)
        assert recorded.requires_grad
        with torch.no_grad():
            direct = fn(*a)
            scale.add_(1.0)
            moved = fn(*a)
            scale.sub_(1.0)
        assert torch.equal(recorded.detach(), direct)
        assert not torch.equal(moved, direct)


def test_modulation_is_read_in_place():
    """The adaLN chunks are fp32 views of one row: read through their row
    stride, without a copy."""
    mod = torch.randn(3, 6 * 8, generator=_g(8))
    ms, mt = mod.chunk(6, dim=-1)[:2]
    a, b, ld = norm_mod._modulation(ms, mt)
    assert ld == 48 and a.data_ptr() == ms.data_ptr() and b.data_ptr() == mt.data_ptr()
    a, b, ld = norm_mod._modulation(ms.to(torch.bfloat16), mt.to(torch.bfloat16))
    assert ld == 8 and a.is_contiguous() and a.dtype == torch.float32


def test_declare_types_a_function_once(monkeypatch):
    class Fn:
        def __init__(self):
            self.typed = 0

        def __setattr__(self, k, v):
            if k == "argtypes":
                object.__setattr__(self, "typed", self.typed + 1)
            object.__setattr__(self, k, v)

    class Lib:
        fn = Fn()

    monkeypatch.setattr(_build, "_DECLARED", {})
    lib = Lib()
    f = _build.declare(lib, "fn", 2, [ctypes.c_int])
    assert _build.declare(lib, "fn", 2, [ctypes.c_int]) is f and f.typed == 1
    assert f.argtypes == [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
