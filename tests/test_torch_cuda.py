"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: on a host without CUDA every test here skips.  On a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not need.)  Small shapes with batch 2 and a non-square grid;
``chip_smoke.py`` holds the kernels at the serving path's full shapes.
Tolerances, per element: |kernel - plain| <= atol + rtol * max |plain -
base| + ulp(plain), where base is the residual the kernel passes through
(x_raw, x, the GroupNorm residual; none for the norms), so rtol holds the
part the kernel computes,
and the ulp term is the output's own rounding.  fp32 (1e-5, 1e-4) for the
same arithmetic summed in another order; bf16 (1e-3, 8e-3), two bf16 ulps
for an intermediate that rounds one ulp apart at an io-dtype rounding point.
The scan backward's seven gradients and the flash kernels' outputs (o, lse,
dq, dk, dv) are held by the same rule with no base.
Each autograd Function is checked once in fp32 (flash attention also in
bf16): its gradients on the card (kernel forward, and a backward through
the kernels) against the same Function on CPU copies (plain versions), per
input ||g_card - g_cpu|| / ||g_cpu|| <= 1e-3.
"""

import math

import pytest
import torch

from founddiff_tpu_torch.ops import attn_block as attn_mod
from founddiff_tpu_torch.ops import experimental_unified as unified_mod
from founddiff_tpu_torch.ops import flash_attention as flash_mod
from founddiff_tpu_torch.ops import groupnorm as gn_mod
from founddiff_tpu_torch.ops import norm as norm_mod
from founddiff_tpu_torch.ops import scan as scan_mod
from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod
from founddiff_tpu_torch.ops import ss2d_fused as fused_mod

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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,W,C", [(2, 24, 40, 128), (2, 16, 16, 96), (2, 8, 24, 160),
                                     (3, 16, 8, 64), (1, 256, 256, 128)])
def test_attn_block_kernel_edges(dev, dtype, B, H, W, C):
    """The redesigned kernel's edges: 8 x 16 pixel tiles that do not divide
    W (40, 24, 8), head counts that are no power of two (3, 5), a last v
    slice of 32 columns (C 96, 160), three images, a full 256^2 C 128 map."""
    g = _gen(B * H * W + C)
    heads = C // 32
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev)
    args = (_n(g, (B, H, W, C), 1.0, dev).to(dtype), _n(g, (B, C), 0.2, dev),
            _n(g, (B, C), 0.2, dev), _n(g, (B, C), 0.5, dev), u(3 * C, C, 1, 1, b=C ** -0.5),
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,D,N", [(46, 30, 64, 4), (22, 14, 96, 12), (12, 20, 64, 64),
                                     (10, 14, 128, 128), (8, 8, 36, 4)])
def test_scan_image_forward_kernel_edges(dev, dtype, H, W, D, N):
    """The redesigned kernel's edges: L not a multiple of the chunk (345 at
    N 4, 77 at N 12, 60 at N 64, 35 at N 128), H != W, N padded (12) and
    in two groups of 64 (128), D below one channel tile (96, 64, 36) and
    one that no 16-byte copy takes (36)."""
    g = _gen(H * W + D + N)
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
@pytest.mark.parametrize("H,W,D,N", [(16, 12, 64, 4), (46, 18, 96, 8)])
def test_scan_image_fn_grads(dev, H, W, D, N):
    g = _gen(4 if D == 64 else D + N)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, D, N, torch.float32, dev)
    x = _n(g, (2, H, W, D), 1.0, dev)
    xw, dtw = _n(g, (4, 4 + 2 * N, D), 0.1, dev), _n(g, (4, D, 4), 0.3, dev)
    _grad_check(lambda x, xw, dtw, A, Ds, b: scan_mod.ScanImageFn.apply(
        x, *ss2d_mod._derive_weights(xw, dtw, 4, N), A, Ds, b), (x, xw, dtw, A, Ds, bias), dev)


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
@pytest.mark.parametrize("B,H,W,C", [(2, 8, 16, 128), (3, 8, 24, 96)])
def test_attn_block_fn_grads(dev, B, H, W, C):
    g = _gen(5 if C == 128 else C)
    heads = C // 32
    args = (_n(g, (B, H, W, C), 1.0, dev), _n(g, (B, C), 0.2, dev), _n(g, (B, C), 0.2, dev),
            _n(g, (B, C), 0.5, dev), _n(g, (3 * C, C, 1, 1), C ** -0.5, dev),
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


# (Lq, Lk) where the tensor-core forward cuts its 16-row warps and 64-key
# tiles, the ragged case of chip_smoke and the bottleneck's 4,096
FLASH_FWD_LENGTHS = [(1, 1), (15, 17), (16, 16), (17, 63), (63, 65), (65, 1), (1000, 777),
                     (4096, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H", [(1, 1), (1, 4), (2, 4)])  # G of 1, 4 and 8
@pytest.mark.parametrize("Lq,Lk", FLASH_FWD_LENGTHS)
def test_flash_forward_kernel(dev, dtype, B, H, Lq, Lk):
    """flash_fwd (both products on the tensor cores, the keys split into
    parts where the query rows alone do not fill the card) against its
    plain version: o and the logsumexp."""
    q, k, v, _ = _flash_inputs(_gen(Lq * 7 + Lk + H), B, H, Lq, Lk, 32, dtype, dev)
    o, lse = flash_mod.flash_fwd(q, k, v, 32 ** -0.5)
    o_p, lse_p = flash_mod.flash_fwd_plain(q, k, v, 32 ** -0.5)
    _close(o, o_p, dtype)
    _close(lse, lse_p, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Lq,Lk", [(1, 4096, 4096), (2, 1000, 777)])
def test_flash_forward_same_bits_on_two_streams(dev, dtype, B, Lq, Lk):
    """Two launches, the second on another stream, give the same bits: the
    key parts are combined in a fixed order, with no atomics."""
    q, k, v, _ = _flash_inputs(_gen(Lq + Lk), B, 4, Lq, Lk, 32, dtype, dev)
    o1, lse1 = flash_mod.flash_fwd(q, k, v, 32 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o2, lse2 = flash_mod.flash_fwd(q, k, v, 32 ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def _flash_bwd_args(g, B, H, Lq, Lk, dtype, dev):
    """The backward's operands, lse and D from the plain forward."""
    q, k, v, do = _flash_inputs(g, B, H, Lq, Lk, 32, dtype, dev)
    o, lse = flash_mod.flash_fwd_plain(q, k, v, 32 ** -0.5)
    dcap = (do.float() * o.float()).sum(-1).reshape(B * H, Lq)
    return q, k, v, do, lse, dcap, 32 ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H", [(1, 1), (1, 4), (2, 4)])  # G of 1, 4 and 8
@pytest.mark.parametrize("Lq,Lk", FLASH_FWD_LENGTHS)
def test_flash_backward_kernels(dev, dtype, B, H, Lq, Lk):
    """flash_bwd_dq and flash_bwd_dkv (every product on the tensor cores,
    the other side split into parts where the rows alone do not fill the
    card) against their plain versions: dq, dk and dv."""
    args = _flash_bwd_args(_gen(Lq * 5 + Lk + H), B, H, Lq, Lk, dtype, dev)
    before = (flash_mod.flash_bwd_dq.launches, flash_mod.flash_bwd_dkv.launches)
    _close(flash_mod.flash_bwd_dq(*args), flash_mod.flash_bwd_dq_plain(*args), dtype)
    for a, b in zip(flash_mod.flash_bwd_dkv(*args), flash_mod.flash_bwd_dkv_plain(*args)):
        _close(a, b, dtype)
    assert (flash_mod.flash_bwd_dq.launches,
            flash_mod.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Lq,Lk", [(1, 4096, 4096), (2, 1000, 777)])
def test_flash_backward_same_bits_on_two_streams(dev, dtype, B, Lq, Lk):
    """Two launches of each backward kernel, the second on another stream,
    give the same dq, dk and dv bits: the parts are combined in a fixed
    order, with no atomics."""
    args = _flash_bwd_args(_gen(Lq + 3 * Lk), B, 4, Lq, Lk, dtype, dev)
    dq1, (dk1, dv1) = flash_mod.flash_bwd_dq(*args), flash_mod.flash_bwd_dkv(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dq2, (dk2, dv2) = flash_mod.flash_bwd_dq(*args), flash_mod.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_fn_grads(dev, dtype):
    q, k, v, _ = _flash_inputs(_gen(8), 2, 2, 150, 90, 32, dtype, dev)
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


def _gn_inputs(g, B, H, W, C, dtype, dev, ss):
    """x [B, H, W, C] at dtype, the GroupNorm affine [C] fp32 and, with ss,
    the time scale/shift as the ``.chunk`` views of one [B, 2C] tensor."""
    x = (_n(g, (B, H, W, C), 1.5, dev) + 0.3).to(dtype)
    gam, bet = _n(g, (C,), 0.1, dev) + 1, _n(g, (C,), 0.1, dev)
    ms, mt = _n(g, (B, 2 * C), 0.2, dev).chunk(2, dim=-1) if ss else (None, None)
    return x, gam, bet, ms, mt


def _gn_units(x, gam, bet, ms, mt, r, groups, dtype):
    """gn_stats and gn_apply each against its plain version, one launch each."""
    B, H, W, C = x.shape
    x3 = x.reshape(B, H * W, C)
    r3 = None if r is None else r.reshape(B, H * W, C)
    before = (gn_mod.gn_stats.launches, gn_mod.gn_apply.launches)
    table = gn_mod.gn_stats(x3, gam, bet, ms, mt, groups, 1e-5)
    want = gn_mod.gn_stats_plain(x3, gam, bet, ms, mt, groups, 1e-5)
    _close(table[:, 0], want[:, 0], torch.float32)
    _close(table[:, 1], want[:, 1], torch.float32)
    _close(gn_mod.gn_apply(x3, want, r3), gn_mod.gn_apply_plain(x3, want, r3), dtype, base=r3)
    assert (gn_mod.gn_stats.launches, gn_mod.gn_apply.launches) == tuple(n + 1 for n in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,res", [(64, True), (128, False)])
def test_group_norm_kernels(dev, dtype, C, res):
    g = _gen(C + res)
    x, gam, bet, ms, mt = _gn_inputs(g, 2, 12, 20, C, dtype, dev, not res)
    r = _n(g, x.shape, 1.0, dev).to(dtype) if res else None
    _gn_units(x, gam, bet, ms, mt, r, 8, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C,groups", [(12, 20, 40, 5), (24, 10, 96, 4), (128, 96, 64, 8),
                                          (45, 45, 1024, 8)])
def test_group_norm_kernel_edges(dev, dtype, H, W, C, groups):
    """A row of C / 8 vectors that does not divide the block (C 40), groups
    4 and 5, many stats blocks an image (128 x 96), and the widest C."""
    g = _gen(C + groups)
    x, gam, bet, ms, mt = _gn_inputs(g, 2, H, W, C, dtype, dev, True)
    _gn_units(x, gam, bet, ms, mt, None, groups, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("res", [True, False])
def test_group_norm_silu_entry(dev, dtype, res, monkeypatch):
    """The epilogue's one C call against the two plain versions: one launch
    of each unit, the same bits on a repeated call and on a second stream."""
    monkeypatch.setenv("FOUNDDIFF_GN", "pallas")
    g = _gen(11 + res)
    B, H, W, C = 2, 128, 96, 64
    x, gam, bet, ms, mt = _gn_inputs(g, B, H, W, C, dtype, dev, not res)
    r = _n(g, x.shape, 1.0, dev).to(dtype) if res else None
    call = lambda: gn_mod.group_norm_silu(x, gam, bet, residual=r,
                                          scale_shift=None if res else (ms, mt))
    before = (gn_mod.gn_stats.launches, gn_mod.gn_apply.launches)
    got = call()
    assert (gn_mod.gn_stats.launches, gn_mod.gn_apply.launches) == tuple(n + 1 for n in before)
    x3, r3 = x.reshape(B, H * W, C), None if r is None else r.reshape(B, H * W, C)
    want = gn_mod.gn_apply_plain(x3, gn_mod.gn_stats_plain(x3, gam, bet, ms, mt, 8, 1e-5), r3)
    _close(got, want.reshape(x.shape), dtype, base=r)
    assert torch.equal(call(), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = call()
    side.synchronize()
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_group_norm_silu_fn_grads(dev, monkeypatch):
    monkeypatch.setenv("FOUNDDIFF_GN", "pallas")
    g = _gen(9)
    args = (_n(g, (2, 12, 20, 64), 1.5, dev), _n(g, (64,), 0.1, dev) + 1, _n(g, (64,), 0.1, dev),
            _n(g, (2, 12, 20, 64), 1.0, dev), _n(g, (2, 64), 0.2, dev), _n(g, (2, 64), 0.2, dev))
    _grad_check(lambda x, s, b, r, ms, mt: gn_mod.group_norm_silu(
        x, s, b, residual=r, scale_shift=(ms, mt), groups=8), args, dev)


def _mamba_args(g, B, H, W, C0, N, dtype, dev, local=True):
    D, R = 2 * C0, -(-C0 // 16)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, D, N, torch.float32, dev)
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev)
    return dict(
        x=(_n(g, (B, H, W, C0), 1.0, dev) + 0.2).to(dtype), ln_scale=_n(g, (C0,), 0.1, dev) + 1,
        ln_bias=_n(g, (C0,), 0.1, dev), mod_scale=_n(g, (B, C0), 0.2, dev),
        mod_shift=_n(g, (B, C0), 0.2, dev), in_proj_w=u(2 * D, C0, b=C0 ** -0.5),
        dw_kernel=u(D, 1, 3, 3, b=1 / 3), dw_bias=u(D, b=1 / 3),
        x_proj_weight=u(4, R + 2 * N, D, b=D ** -0.5), dt_projs_weight=u(4, D, R, b=R ** -0.5),
        A=A, Dskip=Ds, delta_bias=bias, out_ln_g=_n(g, (D,), 0.1, dev) + 1,
        out_ln_b=_n(g, (D,), 0.1, dev), local=_n(g, (B, D), 0.2, dev) if local else None,
        proj_w=u(C0, D, b=D ** -0.5), gate=_n(g, (B, C0), 0.3, dev),
        d_inner=D, dt_rank=R, d_state=N)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C0,N,local", [(16, 12, 32, 4, True), (8, 8, 64, 16, False)])
def test_ss2d_mamba_block_kernel(dev, dtype, H, W, C0, N, local):
    args = _mamba_args(_gen(H * W + C0), 2, H, W, C0, N, dtype, dev, local)
    before = unified_mod.ss2d_mamba_block.launches
    got = unified_mod.ss2d_mamba_block(**args)
    assert unified_mod.ss2d_mamba_block.launches == before + 1
    _close(got, unified_mod.ss2d_mamba_block_plain(**args), dtype, base=args["x"])


# (H = W, C0, d_state) of the nine MambaBlocks of Config() at 512^2
UNET_BLOCKS = [(512, 64, 4), (256, 64, 8), (128, 128, 16), (64, 256, 32), (64, 512, 32),
               (128, 256, 16), (256, 128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,C0,N", UNET_BLOCKS)
def test_ss2d_mamba_block_kernel_at_the_unet_shapes(dev, dtype, H, C0, N):
    """The unified op (the front half with U on chip, then the SS2D tail) at
    the MambaBlock shapes of a 512^2 slice, bs1, against its plain version."""
    args = _mamba_args(_gen(H + C0 + N), 1, H, H, C0, N, dtype, dev)
    _close(unified_mod.ss2d_mamba_block(**args), unified_mod.ss2d_mamba_block_plain(**args),
           dtype, base=args["x"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("B,H,W,C0,N", [(2, 4, 4, 32, 4), (2, 6, 10, 64, 8),
                                        (1, 12, 20, 32, 16)])
def test_ss2d_mamba_block_kernel_edge_grids(dev, dtype, local, B, H, W, C0, N):
    """Grids the 8 x 16 pixel tiles do not divide, whose halo lands on the
    image border on every side."""
    args = _mamba_args(_gen(B * H * W + C0), B, H, W, C0, N, dtype, dev, local)
    _close(unified_mod.ss2d_mamba_block(**args), unified_mod.ss2d_mamba_block_plain(**args),
           dtype, base=args["x"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_ss2d_mamba_block_direct_and_autograd_paths_agree(dev, dtype):
    """A call that needs no gradient launches with weight operands derived
    once per parameter version; one under autograd derives them at the call:
    the same kernel on the same operands gives the same bits."""
    args = _mamba_args(_gen(77), 2, 12, 20, 64, 8, dtype, dev)
    direct = unified_mod.ss2d_mamba_block(**args)
    again = unified_mod.ss2d_mamba_block(**args)  # the derived operands, reused
    args["gate"] = args["gate"].clone().requires_grad_(True)
    tracked = unified_mod.ss2d_mamba_block(**args)
    assert tracked.requires_grad
    assert torch.equal(direct, again) and torch.equal(direct, tracked.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("H,C0,N", [(16, 32, 4), (8, 128, 32)])
def test_ss2d_mamba_block_fn_grads(dev, H, C0, N):
    args = _mamba_args(_gen(H + C0 + 1), 2, H, H, C0, N, torch.float32, dev)
    names = [k for k, v in args.items() if torch.is_tensor(v)]
    _grad_check(lambda *a: unified_mod.ss2d_mamba_block(
        **dict(zip(names, a)), d_inner=2 * C0, dt_rank=-(-C0 // 16), d_state=N),
        [args[k] for k in names], dev)


@pytest.mark.gpu
def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 16, 12, device=dev)  # C % 8 != 0
    with pytest.raises(ValueError):
        gn_mod.gn_stats(x, torch.ones(12, device=dev), torch.zeros(12, device=dev), groups=4)
    args = _mamba_args(_gen(1), 1, 6, 10, 32, 4, torch.float32, dev)
    args["x"] = torch.zeros(1, 7, 10, 32, device=dev)  # odd H
    with pytest.raises(ValueError):
        unified_mod.ss2d_mamba_block(**args)
    args = _mamba_args(_gen(1), 1, 6, 10, 36, 4, torch.float32, dev)  # C0 % 8 != 0
    with pytest.raises(ValueError):
        unified_mod.ss2d_mamba_block(**args)


@pytest.mark.gpu
def test_vector_kernels_refuse_misaligned_tensors(dev):
    """The GroupNorm and flash kernels load 16 bytes at a time: a contiguous
    view that starts one element into its storage is refused, not read."""
    shifted = lambda *s: torch.ones(math.prod(s) + 1, device=dev)[1:].view(*s)
    ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(RuntimeError):
        gn_mod.gn_stats(shifted(2, 16, 64), ones, zeros)
    with pytest.raises(RuntimeError):
        gn_mod.gn_apply(shifted(2, 16, 64), torch.zeros(2, 2, 64, device=dev))
    q = torch.zeros(1, 1, 8, 32, device=dev)
    with pytest.raises(RuntimeError):
        flash_mod.flash_fwd(shifted(1, 1, 8, 32), q, q, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,affine", [(512, True), (40, False)])
def test_layer_norm_kernel(dev, dtype, C, affine):
    g = _gen(C + affine)
    x = (_n(g, (2, 9, 7, C), 1.0, dev) + 0.3).to(dtype)
    scale = _n(g, (C,), 0.1, dev) + 1 if affine else None
    bias = _n(g, (C,), 0.1, dev) if affine else None
    before = norm_mod.layer_norm.launches
    got = norm_mod.layer_norm(x, scale, bias)
    assert norm_mod.layer_norm.launches == before + 1
    _close(got, norm_mod.layer_norm_plain(x, scale, bias), dtype)


def _fused_scan_inputs(g, B, L, D, N, dtype, dev):
    u, _, A, _, _, Ds, bias = _scan_inputs(g, B, L, D, N, dtype, dev)
    w = lambda n: (_n(g, (4, D, n), D ** -0.5, dev)).to(dtype)
    return u, w(D), w(N), w(N), A, Ds, bias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,D,N", [(2, 37, 64, 4), (2, 529, 96, 32), (2, 100, 128, 16),
                                     (4, 529, 1024, 32), (1, 256, 128, 12),
                                     (1, 100, 128, 128)])
def test_scan_fused_forward_kernel(dev, dtype, B, L, D, N):
    """Ragged L (37, 529 = 23^2: a 45^2 grid's padded decimation), a 45^2
    block at bs4 and full width, N = 12 (padded) and 128 (two groups); y and
    h_bounds against the plain version and, in fp32, h_bounds against
    ``scan_forward``'s on the same delta/B/C (the backward's chunks inside
    the passes' longer ones); without h_bounds the same y, bit for bit."""
    args = _fused_scan_inputs(_gen(L + D + 1), B, L, D, N, dtype, dev)
    before = scan_mod.scan_fused_forward.launches
    y, hb = scan_mod.scan_fused_forward(*args)
    assert scan_mod.scan_fused_forward.launches == before + 1
    y_p, hb_p = scan_mod.scan_fused_forward_plain(*args, scan_mod.scan_chunk(N))
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)
    y_only, none = scan_mod.scan_fused_forward(*args, bounds=False)
    assert none is None and torch.equal(y_only, y)
    if dtype == torch.float32:
        xs, wd, wb, wc, A, Ds, bias = args
        _, hb_s = scan_mod.scan_forward(xs, xs @ wd[None], A, xs @ wb[None], xs @ wc[None], Ds,
                                        bias)
        _close(hb, hb_s, torch.float32)


@pytest.mark.gpu
def test_selective_scan_fused_fn_grads(dev):
    args = _fused_scan_inputs(_gen(12), 2, 75, 64, 8, torch.float32, dev)
    _grad_check(scan_mod.SelectiveScanFusedFn.apply, args, dev)


def _epilogue_args(g, B, H, W, C, Co, dtype, dev, local, fold):
    L = (H // 2) * (W // 2)
    args = dict(ys=_n(g, (B, 4, L, C), 1.0, dev).to(dtype), z=_n(g, (B, H, W, C), 1.0, dev).to(dtype),
                scale=_n(g, (C,), 0.1, dev) + 1, bias=_n(g, (C,), 0.1, dev),
                local=_n(g, (B, C), 0.2, dev).to(dtype) if local else None)
    kw = dict(H=H, W=W, gate_silu=True)
    if fold:
        kw.update(proj_w=_n(g, (C, Co), C ** -0.5, dev), gate=_n(g, (B, Co), 0.3, dev),
                  residual_x=_n(g, (B, H, W, Co), 1.0, dev).to(dtype))
    return args, kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B,H,W,C,Co,local,fold", [(2, 2, 2, 512, 256, True, True),
                                                   (2, 12, 20, 64, 32, False, True),
                                                   (2, 8, 6, 96, 96, True, False),
                                                   (1, 2, 2, 1024, 512, True, True),
                                                   (4, 2, 2, 1024, 512, False, True),
                                                   (1, 2, 2, 2048, 64, True, True),
                                                   (1, 10, 8, 136, 72, True, True)])
def test_ss2d_epilogue_kernel(dev, dtype, split, B, H, W, C, Co, local, fold):
    """With fold: the few-pixel tiling at P = 4, 8 and 16 (2x2 grids at bs1,
    2 and 4), the many-pixel tiling at P = 80 (C and Co no multiple of
    their tiles) and 480, and at C 2048 in fp32 the two-launch form (og and
    the weight slice exceed a block's shared memory; bf16 still fits)."""
    args, kw = _epilogue_args(_gen(H * W + C), B, H, W, C, Co, dtype, dev, local, fold)
    ys = args.pop("ys")
    before = fused_mod.merge_ln_gate.launches
    if split:
        rows, cols = ys[:, 0::2], ys[:, 1::2]
        got = fused_mod.merge_ln_gate_split(rows, cols, **args, **kw)
        want = fused_mod.merge_ln_gate_split_plain(rows, cols, **args, **kw)
    else:
        got = fused_mod.merge_ln_gate(ys, **args, **kw)
        want = fused_mod.merge_ln_gate_plain(ys, **args, **kw)
    assert fused_mod.merge_ln_gate.launches == before + 1
    _close(got, want, dtype, base=kw.get("residual_x"))


@pytest.mark.gpu
def test_merge_ln_gate_fn_grads(dev):
    args, kw = _epilogue_args(_gen(13), 2, 6, 4, 64, 32, torch.float32, dev, True, True)
    names = [k for k, v in args.items()] + ["proj_w", "gate", "residual_x"]
    vals = list(args.values()) + [kw.pop(k) for k in ("proj_w", "gate", "residual_x")]
    _grad_check(lambda *a: fused_mod.merge_ln_gate(**dict(zip(names, a)), **kw), vals, dev)


@pytest.mark.gpu
def test_unfused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    args = _fused_scan_inputs(_gen(14), 1, 10, 32, 4, torch.float32, dev)
    with pytest.raises(ValueError):  # d_state 6
        scan_mod.scan_fused_forward(*args[:4], torch.zeros(4, 32, 6, device=dev), *args[5:])
    with pytest.raises(TypeError):
        norm_mod.layer_norm(torch.zeros(4, 16, device=dev, dtype=torch.half))
    a, kw = _epilogue_args(_gen(15), 1, 4, 4, 32, 32, torch.float32, dev, False, False)
    with pytest.raises(ValueError):  # odd W
        fused_mod.merge_ln_gate(a["ys"], a["z"][:, :, :3], a["scale"], a["bias"], H=4, W=3)


def _block_kwargs(g, B, H, W, C0, N, dtype, dev):
    D, R = 2 * C0, -(-C0 // 16)
    u = lambda *s, b: ((torch.rand(s, generator=g) * 2 - 1) * b).to(dev)
    _, _, A, _, _, Ds, bias = _scan_inputs(g, 1, 1, D, N, torch.float32, dev)
    return dict(
        x1=_n(g, (B, H, W, C0), 1.0, dev).to(dtype),
        xs_conv=torch.nn.functional.silu(_n(g, (B, H, W, D), 1.0, dev)).to(dtype),
        x_raw=_n(g, (B, H, W, C0), 1.0, dev).to(dtype), w_z=u(C0, D, b=C0 ** -0.5),
        x_proj_weight=u(4, R + 2 * N, D, b=D ** -0.5), dt_projs_weight=u(4, D, R, b=R ** -0.5),
        A=A, Dskip=Ds, delta_bias=bias, ln_g=_n(g, (D,), 0.1, dev) + 1,
        ln_b=_n(g, (D,), 0.1, dev), local=_n(g, (B, D), 0.2, dev), proj_w=u(D, C0, b=D ** -0.5),
        gate=_n(g, (B, C0), 0.3, dev), dt_rank=R, d_state=N)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,C0,N", [(1, 6, 10, 40, 4), (2, 10, 14, 24, 8),
                                        (2, 8, 6, 36, 16)])
def test_tensor_core_gemm_ragged(dev, monkeypatch, B, H, W, C0, N):
    """The fused block in bf16 with its three products on the tensor cores
    (fd::gemm_tc) against the same block on fd::gemm and against the plain
    version, at widths that leave ragged M, N and K edges in every tile (C0
    36: the z and out_proj widths are no multiple of 8, so those two stay on
    fd::gemm)."""
    args = _block_kwargs(_gen(B * H * W + C0), B, H, W, C0, N, torch.bfloat16, dev)
    tc = ss2d_mod.ss2d_image_block(**args)
    monkeypatch.setattr(ss2d_mod, "TENSOR_CORES", False)
    cuda_cores = ss2d_mod.ss2d_image_block(**args)
    want = ss2d_mod.ss2d_image_block_plain(**args)
    _close(tc, want, torch.bfloat16, base=args["x_raw"])
    _close(cuda_cores, want, torch.bfloat16, base=args["x_raw"])
    _close(tc, cuda_cores, torch.bfloat16, base=args["x_raw"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [64, 100, 1024, 2048])
@pytest.mark.parametrize("aligned", [True, False])
def test_layer_norm_row_kernel(dev, dtype, C, aligned):
    """The row kernel behind ``layer_norm`` and ``layer_norm_modulated``:
    16-byte vectors with the row in registers (C 64, 1024), the scalar loop
    (C 100, no multiple of 8; C 2048, past the registers; and a contiguous
    view that starts one element into its storage)."""
    g = _gen(C + aligned)
    shape = (2, 7, 5, C)
    n = math.prod(shape)
    base = (_n(g, (n + 1,), 1.0, dev) + 0.3).to(dtype)
    x = (base[:n] if aligned else base[1:]).view(shape)
    assert (x.data_ptr() % 16 == 0) == aligned
    scale, bias = _n(g, (C,), 0.1, dev) + 1, _n(g, (C,), 0.1, dev)
    mod = _n(g, (2, 6 * C), 0.2, dev)
    ms, mt = mod.chunk(6, dim=-1)[:2]
    _close(norm_mod.layer_norm(x, scale, bias), norm_mod.layer_norm_plain(x, scale, bias), dtype)
    _close(norm_mod.layer_norm(x, eps=1e-6), norm_mod.layer_norm_plain(x, eps=1e-6), dtype)
    _close(norm_mod.layer_norm_modulated(x, scale, bias, ms, mt),
           norm_mod.layer_norm_modulated_plain(x, scale, bias, ms, mt), dtype)
    _close(norm_mod.layer_norm_modulated(x, None, None, ms, mt, eps=1e-6),
           norm_mod.layer_norm_modulated_plain(x, None, None, ms, mt, eps=1e-6), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_kernels_at_d_state_64(dev, dtype):
    """Every scan kernel at N = 64 (the deepest level of a five-level UNet):
    the forward, the backward (64 KB of shared memory, an opt-in size), the
    fused-projection and image scans, the fused block and the unified op."""
    N, L, D = 64, 40, 64
    g = _gen(64)
    args = _scan_inputs(g, 2, L, D, N, dtype, dev)
    chunk = scan_mod.scan_chunk(N)
    y, hb = scan_mod.scan_forward(*args)
    y_p, hb_p = scan_mod.scan_forward_plain(*args, chunk)
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)
    dy = _n(g, (2, 4, L, D), 1.0, dev).to(dtype)
    for a, b in zip(scan_mod.scan_backward(*args, hb_p, dy),
                    scan_mod.scan_backward_plain(*args, hb_p, dy, chunk)):
        _close(a, b, a.dtype)
    fused = _fused_scan_inputs(g, 2, L, D, N, dtype, dev)
    y, hb = scan_mod.scan_fused_forward(*fused)
    y_p, hb_p = scan_mod.scan_fused_forward_plain(*fused, chunk)
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)
    x = torch.nn.functional.silu(_n(g, (2, 8, 6, D), 1.0, dev)).to(dtype)
    _close(scan_mod.scan_image_forward(x, *fused[1:]),
           scan_mod.scan_image_forward_plain(x, *fused[1:]), dtype)
    blk = _block_kwargs(g, 2, 8, 6, 32, N, dtype, dev)
    _close(ss2d_mod.ss2d_image_block(**blk), ss2d_mod.ss2d_image_block_plain(**blk), dtype,
           base=blk["x_raw"])
    mb = _mamba_args(g, 2, 8, 6, 32, N, dtype, dev)
    _close(unified_mod.ss2d_mamba_block(**mb), unified_mod.ss2d_mamba_block_plain(**mb), dtype,
           base=mb["x"])


@pytest.mark.gpu
def test_selective_scan_fn_grads_at_d_state_64(dev):
    args = _scan_inputs(_gen(65), 2, 100, 64, 64, torch.float32, dev)
    _grad_check(scan_mod.selective_scan, args, dev)


# the six MambaBlock shapes of the 512^2 train step, cut in L (ragged against
# the chunk), then sizes no kernel template holds at ragged L and D
TRAIN_SCAN_SHAPES = [(700, 128, 4), (300, 128, 8), (200, 256, 16), (200, 512, 16),
                     (100, 512, 32), (100, 1024, 32), (77, 100, 12), (45, 36, 6),
                     (45, 72, 128), (40, 40, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,D,N", TRAIN_SCAN_SHAPES)
def test_scan_kernels_any_d_state(dev, dtype, L, D, N):
    """The runtime-N scan_forward (both modes) and scan_backward against
    their plain versions; the bounds-only h_bounds bit for bit."""
    g = _gen(L + D + N)
    args = _scan_inputs(g, 2, L, D, N, dtype, dev)
    chunk = scan_mod.scan_chunk(N)
    y, hb = scan_mod.scan_forward(*args)
    y_p, hb_p = scan_mod.scan_forward_plain(*args, chunk)
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)
    none, hb_only = scan_mod.scan_forward(*args, bounds_only=True)
    assert none is None and torch.equal(hb_only, hb)
    dy = _n(g, (2, 4, L, D), 1.0, dev).to(dtype)
    for a, b in zip(scan_mod.scan_backward(*args, hb_p, dy),
                    scan_mod.scan_backward_plain(*args, hb_p, dy, chunk)):
        _close(a, b, a.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [12, 128])
def test_register_kernels_at_padded_and_grouped_d_state(dev, dtype, N):
    """The kernels that hold the states as a template argument at N = 12
    (padded to 16) and 128 (two groups of 64): the fused-projection and
    image scans, the fused block and the unified op."""
    L, D = 45, 64
    g = _gen(N + 7)
    chunk = scan_mod.scan_chunk(N)
    fused = _fused_scan_inputs(g, 2, L, D, N, dtype, dev)
    y, hb = scan_mod.scan_fused_forward(*fused)
    y_p, hb_p = scan_mod.scan_fused_forward_plain(*fused, chunk)
    assert hb.shape == hb_p.shape
    _close(y, y_p, dtype)
    _close(hb, hb_p, torch.float32)
    x = torch.nn.functional.silu(_n(g, (2, 8, 6, D), 1.0, dev)).to(dtype)
    _close(scan_mod.scan_image_forward(x, *fused[1:]),
           scan_mod.scan_image_forward_plain(x, *fused[1:]), dtype)
    blk = _block_kwargs(g, 2, 8, 6, 32, N, dtype, dev)
    _close(ss2d_mod.ss2d_image_block(**blk), ss2d_mod.ss2d_image_block_plain(**blk), dtype,
           base=blk["x_raw"])
    mb = _mamba_args(g, 2, 8, 6, 32, N, dtype, dev)
    _close(unified_mod.ss2d_mamba_block(**mb), unified_mod.ss2d_mamba_block_plain(**mb), dtype,
           base=mb["x"])


@pytest.mark.gpu
def test_selective_scan_fn_grads_at_d_state_12(dev):
    args = _scan_inputs(_gen(12), 2, 100, 48, 12, torch.float32, dev)
    _grad_check(scan_mod.selective_scan, args, dev)
