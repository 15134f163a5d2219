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
"""

import math

import pytest
import torch

from founddiff_tpu_torch.ops import attn_block as attn_mod
from founddiff_tpu_torch.ops import norm as norm_mod
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
