"""The weight gradients of the projected scans' backward (``ops/scan.py``
``_projected_scan_bwd``, ``_weight_grads``) against a float64 einsum, on the CPU.

Through ``ScanImageFn`` and ``SelectiveScanFusedFn`` under autograd, fp32 and
bf16, at scan lengths that split into chunks with a padded last one and at
lengths that take one chunk.  The gradients the backward hands to
``_weight_grads`` are recorded, and its three sums are held against
``einsum("bkld,bkle->kde")`` of the same tensors in float64; the gradients
autograd returns are those sums cast once to the weights' dtype.
Tolerances from the dtype: fp32 sums over a few thousand rows, 1e-5 of the
largest entry; bf16 one rounding of the fp32 sum, 2^-8 relative.
"""

import pytest
import torch

from founddiff_tpu_torch.ops import scan as tscan
from founddiff_tpu_torch.utils import trace
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _weights(D, N, dtype, gen):
    f = lambda *s: torch.randn(*s, generator=gen)
    return (f(4, D, D).mul(D ** -0.5).to(dtype), f(4, D, N).mul(D ** -0.5).to(dtype),
            f(4, D, N).mul(D ** -0.5).to(dtype), -f(4, D, N).abs() - 0.5, f(4, D),
            f(4, D) * 0.1)


# (Function, input shape, N, chunks S): 100x100 images scan L = 2,500 in 3
# chunks of 834 (2 zero rows), L = 1,025 in 2 of 513 (1 zero row); 16x16
# images (L = 64) and L = 300 take one chunk
CASES = [
    ("image", (2, 100, 100, 8), 4, 3),
    ("image", (2, 16, 16, 8), 4, 1),
    ("fused", (2, 4, 1025, 8), 3, 2),
    ("fused", (1, 4, 300, 16), 8, 1),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn,shape,N,S", CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}" for c in CASES])
def test_weight_grads_against_float64(monkeypatch, fn, shape, N, S, dtype):
    gen = torch.Generator().manual_seed(sum(shape) + N)
    x = torch.randn(*shape, generator=gen).to(dtype).requires_grad_()
    w = [t.requires_grad_() for t in _weights(shape[-1], N, dtype, gen)]
    seen = []
    inner = tscan._weight_grads

    def spy(*args):
        out = inner(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(tscan, "_weight_grads", spy)
    apply = tscan.ScanImageFn.apply if fn == "image" else tscan.SelectiveScanFusedFn.apply
    y = apply(x, *w)
    before = trace.counters()
    grads = torch.autograd.grad(torch.tanh(y.float()).sum(), [x, *w[:3]])
    assert trace.counters(before) == {"scan_wgrad.chunks": shape[0] * 4 * S}
    ((xs, gdl, gb, gc), sums), = seen
    L = xs.shape[2]
    assert xs.shape == (shape[0], 4, L, shape[-1]) and xs.dtype == gdl.dtype == dtype
    assert -(-L // tscan._WGRAD_CHUNK) == S
    for name, got, g, wt, out in zip(("w_delta", "w_b", "w_c"), sums, (gdl, gb, gc), w[:3],
                                     grads[1:]):
        want = torch.einsum("bkld,bkle->kde", xs.double(), g.double())
        assert got.dtype == torch.float32 and out.dtype == wt.dtype
        assert torch.equal(out, got.to(wt.dtype)), name
        rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
        torch.testing.assert_close(out.double(), want, rtol=rtol,
                                   atol=1e-5 * want.abs().max().item(), msg=name)
