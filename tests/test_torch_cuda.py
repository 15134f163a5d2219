"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without CUDA every test here skips.  On a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not need.)  Small shapes with batch 2 and a non-square grid;
``chip_smoke.py`` holds the kernels at the serving path's full shapes.
Tolerances, per element: |kernel - plain| <= atol + rtol * max |plain -
base| + ulp(plain), where base is the residual the kernel passes through
(x_raw, x; none for the norm), so rtol holds the part the kernel computes,
and the ulp term is the output's own rounding.  fp32 (1e-5, 1e-4) for the
same arithmetic summed in another order; bf16 (1e-3, 8e-3), two bf16 ulps
for an intermediate that rounds one ulp apart at an io-dtype rounding point.
The scan backward's seven gradients and the flash kernels' outputs (o, lse,
dq, dk, dv) are held by the same rule with no base.
Each autograd Function is checked once in fp32: its gradients on the card
(kernel forward, and a backward through the scan kernels) against the same
Function on CPU copies (plain versions), per input ||g_card - g_cpu|| /
||g_cpu|| <= 1e-3.
"""

import math

import pytest
import torch

from founddiff_tpu_torch.ops import attn_block as attn_mod
from founddiff_tpu_torch.ops import flash_attention as flash_mod
from founddiff_tpu_torch.ops import norm as norm_mod
from founddiff_tpu_torch.ops import scan as scan_mod
from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 8e-3)}
MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, base=None):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    got, want = got.float(), want.float()
    computed = want if base is None else want - base.float()
    top = torch.maximum(got.abs(), want.abs())
    _, e = torch.frexp(top)
    out_ulp = torch.ldexp((top != 0).float(), (e - 1 - MANTISSA_BITS[dtype]).float())
    excess = ((got - want).abs() - out_ulp).max().item()
    assert excess <= atol + rtol * computed.abs().max().item(), excess


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _n(g, shape, std, dev):
    return (torch.randn(shape, generator=g) * std).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,affine", [(64, True), (256, False)])
def test_layer_norm_modulated_kernel(dev, dtype, C, affine):
    g = _gen(C)
    x = _n(g, (2, 12, 20, C), 1.0, dev).to(dtype)
    scale = _n(g, (C,), 0.1, dev) + 1 if affine else None
    bias = _n(g, (C,), 0.1, dev) if affine else None
    ms, mt = _n(g, (2, C), 0.2, dev), _n(g, (2, C), 0.2, dev)
    eps = 1e-5 if affine else 1e-6
    before = norm_mod.layer_norm_modulated.launches
    got = norm_mod.layer_norm_modulated(x, scale, bias, ms, mt, eps=eps)
    assert norm_mod.layer_norm_modulated.launches == before + 1
    _close(got, norm_mod.layer_norm_modulated_plain(x, scale, bias, ms, mt, eps=eps), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C0,N,local", [(16, 12, 32, 4, True), (8, 8, 64, 16, False)])
def test_ss2d_image_block_kernel(dev, dtype, H, W, C0, N, local):
    g = _gen(H * W + C0)
    B, D, R = 2, 2 * C0, -(-C0 // 16)
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev)
    dt = torch.exp(torch.rand((4, D), generator=g) * math.log(100) + math.log(1e-3))
    args = dict(
        x1=_n(g, (B, H, W, C0), 1.0, dev).to(dtype),
        xs_conv=torch.nn.functional.silu(_n(g, (B, H, W, D), 1.0, dev)).to(dtype),
        x_raw=_n(g, (B, H, W, C0), 1.0, dev).to(dtype),
        w_z=u(C0, D, b=C0 ** -0.5), x_proj_weight=u(4, R + 2 * N, D, b=D ** -0.5),
        dt_projs_weight=u(4, D, R, b=R ** -0.5),
        A=-torch.arange(1, N + 1.0).expand(4, D, N).contiguous().to(dev),
        Dskip=torch.ones(4, D, device=dev), delta_bias=(dt + torch.log(-torch.expm1(-dt))).to(dev),
        ln_g=_n(g, (D,), 0.1, dev) + 1, ln_b=_n(g, (D,), 0.1, dev),
        local=_n(g, (B, D), 0.2, dev) if local else None, proj_w=u(D, C0, b=D ** -0.5),
        gate=_n(g, (B, C0), 0.3, dev), dt_rank=R, d_state=N)
    before = ss2d_mod.ss2d_image_block.launches
    got = ss2d_mod.ss2d_image_block(**args)
    assert ss2d_mod.ss2d_image_block.launches == before + 1
    _close(got, ss2d_mod.ss2d_image_block_plain(**args), dtype, base=args["x_raw"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C", [(16, 24, 128), (8, 8, 256)])
def test_attn_block_kernel(dev, dtype, H, W, C):
    g = _gen(H * W + C)
    heads = C // 32
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev)
    args = (_n(g, (2, H, W, C), 1.0, dev).to(dtype), _n(g, (2, C), 0.2, dev),
            _n(g, (2, C), 0.2, dev), _n(g, (2, C), 0.5, dev), u(3 * C, C, 1, 1, b=C ** -0.5),
            u(3 * C, 1, 3, 3, b=1 / 3), _n(g, (heads, 1, 1), 0.3, dev).abs() + 0.5,
            u(C, C, 1, 1, b=C ** -0.5))
    before = attn_mod.attn_block.launches
    got = attn_mod.attn_block(*args, heads=heads)
    assert attn_mod.attn_block.launches == before + 1
    _close(got, attn_mod.attn_block_plain(*args, heads=heads), dtype, base=args[0])


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A CUDA tensor reaches the kernel or an exception, never the plain path."""
    x = torch.zeros(1, 6, 6, 64, device=dev)  # H % 8 != 0
    z = torch.zeros(1, 64, device=dev)
    w = torch.zeros(64, 64, 1, 1, device=dev)
    with pytest.raises(ValueError):
        attn_mod.attn_block(x, z, z, z, torch.zeros(192, 64, 1, 1, device=dev),
                            torch.zeros(192, 1, 3, 3, device=dev),
                            torch.ones(2, 1, 1, device=dev), w, heads=2)
    with pytest.raises(TypeError):
        norm_mod.layer_norm_modulated(x.half(), None, None, z, z)


def _scan_inputs(g, B, L, D, N, dtype, dev):
    K = 4
    dt = torch.exp(torch.rand((K, D), generator=g) * math.log(100) + math.log(1e-3))
    return (_n(g, (B, K, L, D), 1.0, dev).to(dtype), _n(g, (B, K, L, D), 0.5, dev).to(dtype),
            -torch.rand((K, D, N), generator=g).add(0.1).mul(N).to(dev),
            _n(g, (B, K, L, N), 1.0, dev).to(dtype), _n(g, (B, K, L, N), 1.0, dev).to(dtype),
            _n(g, (K, D), 1.0, dev), (dt + torch.log(-torch.expm1(-dt))).to(dev))


SCAN_SHAPES = [(75, 40, 4), (256, 64, 8), (100, 96, 16), (64, 128, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,D,N", SCAN_SHAPES)
def test_scan_forward_kernel(dev, dtype, L, D, N):
    args = _scan_inputs(_gen(L + D), 2, L, D, N, dtype, dev)
    chunk = scan_mod.scan_chunk(N)
    before = scan_mod.scan_forward.launches
    y, hb = scan_mod.scan_forward(*args)
    assert scan_mod.scan_forward.launches == before + 1
    y_p, hb_p = scan_mod.scan_forward_plain(*args, chunk)
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,D,N", SCAN_SHAPES)
def test_scan_backward_kernel(dev, dtype, L, D, N):
    g = _gen(L * D)
    args = _scan_inputs(g, 2, L, D, N, dtype, dev)
    chunk = scan_mod.scan_chunk(N)
    _, hb = scan_mod.scan_forward_plain(*args, chunk)
    dy = _n(g, (2, 4, L, D), 1.0, dev).to(dtype)
    before = scan_mod.scan_backward.launches
    got = scan_mod.scan_backward(*args, hb, dy)
    assert scan_mod.scan_backward.launches == before + 1
    want = scan_mod.scan_backward_plain(*args, hb, dy, chunk)
    for a, b in zip(got, want):
        _close(a, b, a.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,D,N", [(16, 12, 64, 4), (8, 8, 128, 16), (8, 12, 96, 32)])
def test_scan_image_forward_kernel(dev, dtype, H, W, D, N):
    g = _gen(H * W + D)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, D, N, dtype, dev)
    x = torch.nn.functional.silu(_n(g, (2, H, W, D), 1.0, dev)).to(dtype)
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev).to(dtype)
    w = (u(4, D, D, b=D ** -0.5), u(4, D, N, b=D ** -0.5), u(4, D, N, b=D ** -0.5))
    before = scan_mod.scan_image_forward.launches
    got = scan_mod.scan_image_forward(x, *w, A, Ds, bias)
    assert scan_mod.scan_image_forward.launches == before + 1
    _close(got, scan_mod.scan_image_forward_plain(x, *w, A, Ds, bias), dtype)


def _grad_check(fn, args, dev):
    """fn's gradients on the card against fn on CPU copies (plain versions);
    fp32, per input relative norm <= 1e-3; a fixed random cotangent."""
    def grads(device):
        xs = [a.detach().to(device).requires_grad_(a.is_floating_point())
              if torch.is_tensor(a) else a for a in args]
        out = fn(*xs)
        gen = torch.Generator().manual_seed(7)
        cot = torch.randn(out.shape, generator=gen).to(device)
        wrt = [x for x in xs if torch.is_tensor(x) and x.requires_grad]
        return torch.autograd.grad(out, wrt, cot)

    for a, b in zip(grads(dev), grads("cpu")):
        assert a is not None and torch.isfinite(a).all()
        rel = ((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3, rel


@pytest.mark.gpu
def test_selective_scan_fn_grads(dev):
    args = _scan_inputs(_gen(3), 2, 300, 64, 8, torch.float32, dev)
    _grad_check(scan_mod.selective_scan, args, dev)


@pytest.mark.gpu
def test_scan_image_fn_grads(dev):
    g = _gen(4)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, 64, 4, torch.float32, dev)
    x = _n(g, (2, 16, 12, 64), 1.0, dev)
    xw, dtw = _n(g, (4, 4 + 8, 64), 0.1, dev), _n(g, (4, 64, 4), 0.3, dev)
    _grad_check(lambda x, xw, dtw, A, Ds, b: scan_mod.ScanImageFn.apply(
        x, *ss2d_mod._derive_weights(xw, dtw, 4, 4), A, Ds, b), (x, xw, dtw, A, Ds, bias), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("H,C0,N", [(16, 32, 4), (8, 128, 32)])
def test_ss2d_image_block_fn_grads(dev, H, C0, N):
    g = _gen(H + C0)
    B, D, R = 2, 2 * C0, -(-C0 // 16)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, D, N, torch.float32, dev)
    args = (_n(g, (B, H, H, C0), 1.0, dev), _n(g, (B, H, H, D), 1.0, dev),
            _n(g, (B, H, H, C0), 1.0, dev), _n(g, (C0, D), C0 ** -0.5, dev),
            _n(g, (4, R + 2 * N, D), D ** -0.5, dev), _n(g, (4, D, R), R ** -0.5, dev), A, Ds,
            bias, _n(g, (D,), 0.1, dev) + 1, _n(g, (D,), 0.1, dev), _n(g, (B, D), 0.2, dev),
            _n(g, (D, C0), D ** -0.5, dev), _n(g, (B, C0), 0.3, dev))
    _grad_check(lambda *a: ss2d_mod.ss2d_image_block(*a, dt_rank=R, d_state=N), args, dev)


@pytest.mark.gpu
def test_attn_block_fn_grads(dev):
    g = _gen(5)
    C, heads = 128, 4
    args = (_n(g, (2, 8, 16, C), 1.0, dev), _n(g, (2, C), 0.2, dev), _n(g, (2, C), 0.2, dev),
            _n(g, (2, C), 0.5, dev), _n(g, (3 * C, C, 1, 1), C ** -0.5, dev),
            _n(g, (3 * C, 1, 3, 3), 1 / 3, dev), _n(g, (heads, 1, 1), 0.3, dev).abs() + 0.5,
            _n(g, (C, C, 1, 1), C ** -0.5, dev))
    _grad_check(lambda *a: attn_mod.attn_block(*a, heads=heads), args, dev)


@pytest.mark.gpu
def test_layer_norm_modulated_fn_grads(dev):
    g = _gen(6)
    args = (_n(g, (2, 8, 12, 64), 1.0, dev), _n(g, (64,), 0.1, dev) + 1, _n(g, (64,), 0.1, dev),
            _n(g, (2, 64), 0.2, dev), _n(g, (2, 64), 0.2, dev))
    _grad_check(norm_mod.layer_norm_modulated, args, dev)


# (B, H, Lq, Lk, d): ragged lengths (the kernels cut the last tile), whole tiles
FLASH_SHAPES = [(2, 2, 100, 77, 32), (1, 3, 64, 64, 32), (2, 1, 130, 200, 32)]


def _flash_inputs(g, B, H, Lq, Lk, d, dtype, dev):
    return (_n(g, (B, H, Lq, d), 1.0, dev).to(dtype), _n(g, (B, H, Lk, d), 1.0, dev).to(dtype),
            _n(g, (B, H, Lk, d), 1.0, dev).to(dtype), _n(g, (B, H, Lq, d), 1.0, dev).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Lq,Lk,d", FLASH_SHAPES)
def test_flash_kernels(dev, dtype, B, H, Lq, Lk, d):
    q, k, v, do = _flash_inputs(_gen(Lq + Lk + d), B, H, Lq, Lk, d, dtype, dev)
    scale = d ** -0.5
    before = (flash_mod.flash_fwd.launches, flash_mod.flash_bwd_dq.launches,
              flash_mod.flash_bwd_dkv.launches)
    o, lse = flash_mod.flash_fwd(q, k, v, scale)
    o_p, lse_p = flash_mod.flash_fwd_plain(q, k, v, scale)
    _close(o, o_p, dtype)
    _close(lse, lse_p, torch.float32)
    dcap = (do.float() * o_p.float()).sum(-1).reshape(B * H, Lq)
    args = (q, k, v, do, lse_p, dcap, scale)
    _close(flash_mod.flash_bwd_dq(*args), flash_mod.flash_bwd_dq_plain(*args), dtype)
    for a, b in zip(flash_mod.flash_bwd_dkv(*args), flash_mod.flash_bwd_dkv_plain(*args)):
        _close(a, b, dtype)
    assert (flash_mod.flash_fwd.launches, flash_mod.flash_bwd_dq.launches,
            flash_mod.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.gpu
def test_flash_attention_fn_grads(dev):
    q, k, v, _ = _flash_inputs(_gen(8), 2, 2, 150, 90, 32, torch.float32, dev)
    _grad_check(flash_mod.flash_attention, (q, k, v), dev)


@pytest.mark.gpu
def test_flash_refuses_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 1, 8, 64, device=dev)  # head dim 64
    with pytest.raises(ValueError):
        flash_mod.flash_fwd(q, q, q, 1.0)
    q = torch.zeros(1, 1, 8, 32, device=dev)
    with pytest.raises(TypeError):
        flash_mod.flash_fwd(q, q.bfloat16(), q, 1.0)
    with pytest.raises(TypeError):
        flash_mod.flash_fwd(q.half(), q.half(), q.half(), 1.0)
