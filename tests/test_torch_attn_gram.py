"""``transposed_attention`` (``ops/attn_block.py``) against the full-Gram
composition it replaced (CPU).

The oracle is that composition, kept here: the [B, 2C, 2C] Gram of [q; k]
over the pixels, its diagonal for the row norms and a loop over the heads
for the diagonal blocks of ``G[:, :C, C:]``, with every sum in float64 and
the port's io-dtype rounding points (u, the depthwise conv's output, M and
the output).  The port's path is held to it in the forward and in the
gradients of its five tensor arguments:

- C 32, 64, 96, 128 (1 to 4 heads of 32 channels) on 16x16, 45x45 and
  12x20 maps, fp32 and bf16; 45^2 = 2,025 pixels are two chunks of 1,013
  with a zero row padding the last;
- the chunk set small, so that a map splits into several chunks, evenly
  (16x16 in 4) and not (12x20 in 35 of 7, 16x16 in 3 of 86);
- the products it records, forward and backward: none has the [2C, 2C]
  Gram's shape, and each that sums over pixels takes one chunk.

Tolerance, per tensor: max |port - oracle| <= tol * max |oracle|; fp32
1e-5 (fp32 sums against float64 ones; the composition this replaced reads
up to 1e-6 at these shapes), and 1e-4 for the temperature's gradient, a
sum whose terms cancel (a softmax's gradient sums to zero along a row),
where the replaced composition in fp32 reads up to 2e-5; bf16 1e-2 (an
intermediate that rounds one bf16 ulp apart at a rounding point, 2^-8,
carried through the softmax and the products; both compositions read up
to 4.4e-3).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from founddiff_tpu_torch.ops import attn_block as tattn
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TEMPERATURE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ("x2", "qkv_w", "dw_w", "temperature", "proj_w")


def full_gram(x2, qkv_w, dw_w, temperature, proj_w, heads):
    """The full-Gram composition with float64 sums and the io-dtype rounding
    points of the port."""
    f = lambda t: t.double()
    B, H, W, C = x2.shape
    io = x2.dtype
    ch = C // heads
    w = f(qkv_w[:, :, 0, 0].t().to(io))
    u = (f(x2) @ w).to(io)
    taps = f(dw_w.to(io))
    qkv = F.conv2d(f(u).permute(0, 3, 1, 2), taps, padding=1, groups=3 * C)
    qkv = f(qkv.permute(0, 2, 3, 1).to(io)).reshape(B, H * W, 3 * C)
    qk = qkv[..., :2 * C]
    G = qk.transpose(1, 2) @ qk  # [B, 2C, 2C]
    diag = torch.diagonal(G, dim1=1, dim2=2)
    qn = torch.sqrt(diag[:, :C]).clamp_min(1e-12).reshape(B, heads, ch)
    kn = torch.sqrt(diag[:, C:]).clamp_min(1e-12).reshape(B, heads, ch)
    blocks = G[:, :C, C:]
    attn = torch.stack([blocks[:, i * ch:(i + 1) * ch, i * ch:(i + 1) * ch]
                        for i in range(heads)], dim=1)  # [B, h, c, d]
    attn = attn / (qn[..., None] * kn[:, :, None, :])
    attn = torch.softmax(attn * f(temperature), dim=-1)
    pk = f(proj_w[:, :, 0, 0].t()).reshape(heads, ch, C)
    M = torch.einsum("hce,bhcd->bhde", pk, attn).reshape(B, C, C).to(io)
    out = (qkv[..., 2 * C:] @ f(M)).to(io)
    return out.reshape(B, H, W, C)


def _inputs(H, W, C, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g)
    heads = C // 32
    args = (n(2, H, W, C).to(dtype), n(3 * C, C, 1, 1) * C ** -0.5, n(3 * C, 1, 3, 3) / 3,
            torch.rand(heads, 1, 1, generator=g) + 0.5, n(C, C, 1, 1) * C ** -0.5)
    return heads, args, n(2, H, W, C).to(dtype)


def assert_matches_full_gram(args, heads, g):
    """``transposed_attention(*args)`` against :func:`full_gram` on copies of
    ``args``: the output and the gradients at cotangent ``g``."""
    dtype = args[0].dtype
    port = [a.clone().requires_grad_() for a in args]
    oracle = [a.clone().requires_grad_() for a in args]
    got = tattn.transposed_attention(*port, heads)
    want = full_gram(*oracle, heads)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    pairs = [("out", got, want)]
    pairs += zip(NAMES, torch.autograd.grad(got, port, g), torch.autograd.grad(want, oracle, g))
    for name, a, b in pairs:
        a, b = a.double(), b.double()
        assert torch.isfinite(a).all(), name
        gap = ((a - b).abs().max() / b.abs().max()).item()
        tol = (TEMPERATURE_TOL if name == "temperature" else TOL)[dtype]
        assert gap <= tol, f"{name}: {gap:.3g} over {tol}"


def _check(H, W, C, dtype, seed):
    heads, args, g = _inputs(H, W, C, dtype, seed)
    assert_matches_full_gram(args, heads, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,W", [(16, 16), (45, 45), (12, 20)])
@pytest.mark.parametrize("C", [32, 64, 96, 128])
def test_against_full_gram(C, H, W, dtype):
    _check(H, W, C, dtype, seed=C * 1000 + H * W)


@pytest.mark.parametrize("H,W,chunk", [(16, 16, 64), (12, 20, 7), (16, 16, 86)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_chunks(monkeypatch, H, W, chunk, dtype):
    monkeypatch.setattr(tattn, "_PIX_CHUNK", chunk)
    _check(H, W, 64, dtype, seed=chunk)


class _Products(TorchDispatchMode):
    """The operand shapes of every matrix product dispatched."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.OPS:
            a, b = (args[1], args[2]) if func in (torch.ops.aten.addmm.default,
                                                    torch.ops.aten.baddbmm.default) else args[:2]
            self.seen.append((tuple(a.shape), tuple(b.shape), tuple(out.shape)))
        return out


@pytest.mark.parametrize("H,W,C", [(16, 16, 64), (12, 20, 128)])
def test_products_take_one_chunk(monkeypatch, H, W, C):
    """No product forms the [2C, 2C] Gram or its gradient, none sums over an
    image's pixels whole, and the blocks and v @ M's weight gradient each
    sum over one chunk (256 pixels: 6 chunks of 43; 240: 5 of 48)."""
    monkeypatch.setattr(tattn, "_PIX_CHUNK", 48)
    P = H * W
    S = -(-P // 48)
    Pc = -(-P // S)
    heads, args, g = _inputs(H, W, C, torch.float32, seed=7)
    args = [a.requires_grad_() for a in args]
    with _Products() as rec:
        torch.autograd.grad(tattn.transposed_attention(*args, heads), args, g)
    shapes = [s for a, b, out in rec.seen for s in (a, b, out)]
    assert shapes and not any(2 * C in s[-2:] for s in shapes), rec.seen
    sums = [a[-1] for a, _, _ in rec.seen]
    assert P not in sums and S * Pc not in sums, rec.seen
    # the forward's blocks [c, c] and the weight gradient of v @ M [C, C]
    chunked = {out[-2:] for a, _, out in rec.seen if a[-1] == Pc}
    assert chunked == {(32, 32), (C, C)}, rec.seen
