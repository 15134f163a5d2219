"""The least times ``chip_smoke.py`` holds the kernels against, computed on
the CPU from the shapes alone.

fp32 products count as three TF32 products on the tensor cores (494.7
TFLOP/s dense, so 164.9 TFLOP/s of fp32 products), the way the port's fp32
kernels run them; fp32 work that is not a product stays at the CUDA cores'
67 TFLOP/s; bf16 products at 989 TFLOP/s.  Exact to rounding (rel 1e-9).
"""

import math

import pytest
import torch

import chip_smoke as cs

SFU = 16 * 132 * 1.98e9  # exponentials/s at 132 SMs and a 1,980 MHz clock
REL = 1e-9


@pytest.fixture
def sfu(monkeypatch):
    monkeypatch.setattr(cs, "SFU_EXP_PER_S", SFU)


def test_peak_rates():
    assert cs.PEAK_FLOPS[torch.float32] == pytest.approx(494.7e12 / 3, rel=REL)
    assert cs.PEAK_FLOPS[torch.bfloat16] == 989e12
    assert cs.FP32_FLOPS == 67e12


@pytest.mark.parametrize("dtype,peak", [(torch.float32, 494.7e12 / 3),
                                        (torch.bfloat16, 989e12)])
def test_flash_forward_bound(sfu, dtype, peak):
    """flash_fwd at the vanilla bottleneck, B1 H4 L 4,096 d 32: 4d flops a
    (query, key) pair, 8.59e9 in all; in fp32 3 * 8.59e9 / 494.7e12 s."""
    G, L, d = 4, 4096, 32
    args, _, _, moved, work, _ = cs.flash_case("flash_fwd", 1, L, L, dtype,
                                               torch.Generator().manual_seed(0),
                                               torch.device("cpu"))
    flops = 4 * G * L * L * d
    assert flops == pytest.approx(8.59e9, rel=1e-3)
    isz = torch.tensor([], dtype=dtype).element_size()
    assert moved == 4 * G * L * d * isz + 4 * G * L  # q, k, v in, o out; lse fp32
    ms, t_bytes, t_ops = cs.bound_ms(moved, work)
    want = max(flops / peak, G * L * L / SFU) * 1e3
    assert t_ops == pytest.approx(want, rel=REL)
    assert ms == pytest.approx(max(want, moved / 3.35e12 * 1e3), rel=REL)
    if dtype == torch.float32:
        assert ms == pytest.approx(3 * 8.589934592e9 / 494.7e12 * 1e3, rel=REL)
        assert 0.052 < ms < 0.0522


@pytest.mark.parametrize("dtype,peak", [(torch.float32, 494.7e12 / 3),
                                        (torch.bfloat16, 989e12)])
@pytest.mark.parametrize("kname,per_pair", [("flash_bwd_dq", 6), ("flash_bwd_dkv", 8)])
def test_flash_backward_bound(sfu, dtype, peak, kname, per_pair):
    """The backward kernels at phase 2's ragged case, B2 H4 Lq 1,000 Lk 777
    d 32: 6d flops a (query, key) pair for dq (S, dP, dQ), 8d for dk/dv (S,
    dP, dV, dK) at the products' peak, one exponential a pair; q, k, v, do
    and the fp32 lse and D read once, the gradients written once."""
    B, Lq, Lk, d = 2, 1000, 777, 32
    G = 4 * B
    args, _, _, moved, work, _ = cs.flash_case(kname, B, Lq, Lk, dtype,
                                               torch.Generator().manual_seed(0),
                                               torch.device("cpu"))
    assert [a.shape for a in args[:4]] == [(B, 4, Lq, d), (B, 4, Lk, d), (B, 4, Lk, d),
                                           (B, 4, Lq, d)]
    assert args[4].shape == args[5].shape == (G, Lq) and args[6] == d ** -0.5
    isz = torch.tensor([], dtype=dtype).element_size()
    written = G * Lq * d if kname == "flash_bwd_dq" else 2 * G * Lk * d
    assert moved == (2 * G * Lq * d + 2 * G * Lk * d + written) * isz + 2 * 4 * G * Lq
    flops = per_pair * G * Lq * Lk * d
    assert work == [(flops, peak), (G * Lq * Lk, SFU)]
    ms, t_bytes, t_ops = cs.bound_ms(moved, work)
    assert t_ops == pytest.approx(max(flops / peak, G * Lq * Lk / SFU) * 1e3, rel=REL)
    assert t_bytes == pytest.approx(moved / 3.35e12 * 1e3, rel=REL)
    assert ms == max(t_ops, t_bytes) == t_ops  # operations bound both kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_block_bound(dtype):
    """ss2d_mamba_block at one MambaBlock of Config() at 512^2 (64^2, C0
    256, N 32) at bs1: the products (in_proj's two halves and out_proj,
    delta through its rank-R factors, B and C) at the products' rate, the
    depthwise 3x3, the LayerNorms and the scan at the CUDA cores' rate."""
    B, H, C0, N = 1, 64, 256, 32
    D, R, P = 2 * C0, C0 // 16, B * H * H
    _, _, _, moved, work = cs.mamba_case(B, H, C0, N, dtype, torch.Generator().manual_seed(1),
                                         torch.device("cpu"))
    mm = 2 * P * (3 * C0 * D + 2 * D * R + 2 * N * D)
    fp32 = P * (18 * D + 5 * C0 + 5 * D + 6 * D * N)
    assert work == [(mm, cs.PEAK_FLOPS[dtype]), (fp32, cs.FP32_FLOPS)]
    ms, t_bytes, t_ops = cs.bound_ms(moved, work)
    peak = 494.7e12 / 3 if dtype == torch.float32 else 989e12
    assert t_ops == pytest.approx(max(mm / peak, fp32 / 67e12) * 1e3, rel=REL)
    assert t_bytes == pytest.approx(moved / 3.35e12 * 1e3, rel=REL)
    assert ms == max(t_ops, t_bytes)
    assert math.isclose(mm, 2 * 4096 * (3 * 256 * 512 + 2 * 512 * 16 + 2 * 32 * 512))
