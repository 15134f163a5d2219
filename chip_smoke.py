#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit,
   turns TF32 off (for every fp32 comparison, and for the fp32 serving and
   training of phases 7-11), builds the eight kernel libraries from
   ``founddiff_tpu_torch/csrc`` (one nvcc per source, all started together)
   and prints the build seconds.  Phases 1-9 run with ``FOUNDDIFF_GN`` and
   ``FOUNDDIFF_UNIFIED`` unset (the default routes); 10 and 11 set them.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every distinct shape its path gives it: the serving kernels
   at bs1 and bs4, the scan kernels at the training batch (2 slices per
   microbatch, so 8 direction sequences), the flash kernels at the vanilla
   UNet's bottleneck ([1, 4, 4096, 32] serving, [2, 4, 4096, 32] training)
   and at a ragged Lq 1000 / Lk 777, the GroupNorm pair at the seven (H, C)
   of both UNets at batches 1, 2 and 4 (``gn_apply`` with the residual and,
   without one, with the time scale/shift folded in), the unified op at the
   MambaBlock shapes at batches 1, 2 and 4, in fp32 and bf16, with the stated
   tolerance (the scan backward's seven gradients each); prints the errors,
   the kernel's and the plain version's times (CUDA events, warmed up,
   median of 7), the bound (the largest of bytes / 3.35 TB/s, operations /
   the peak rate of their unit, and for the flash kernels the exponentials /
   the SFU rate, 16 per SM per clock at the card's maximum SM clock) and,
   for the flash kernels, the time of ``scaled_dot_product_attention`` (its
   forward; its backward through autograd for the two backward kernels),
   for the GroupNorm pair that of ``F.group_norm`` on a contiguous NCHW
   copy, in ``gn_apply``'s rows only (the pair's one yardstick: the
   normalisation and a per-channel affine, without the per-image fold, the
   silu or the residual).
3. Main path at full width: ``build(Config())`` on the card (dim 64 x
   (1, 2, 4, 8), full RN50 CLIPIQA tower, seeded random weights with
   non-zero adaLN and prompt), ``make_hoisted_sampler(...,
   compute_dtype=torch.bfloat16)``, 2-step DDIM on 4 requests of one 512^2
   slice and 2 batches of 4.  Checks the outputs and the launch counts of
   each kernel (9 ``ss2d_image_block``, 6 ``attn_block`` and 12
   ``layer_norm_modulated`` per UNet forward); prints slices/s and peak
   memory.
4. Numerics gate: the same bs1 request through the kernel path and through
   the plain path (the three kernels swapped for their plain versions), PSNR
   >= 40 dB on the [0, 1] output window.
5. Profile: one bs1 and one bs4 request under ``torch.profiler``; prints
   the wall time, the device's busy time and the device time by kernel.
6. Autograd on the card: one MambaBlock on the image-scan route (256^2,
   C 128) and one on the decimated-scan route (64^2, C 512), batch 2, fp32:
   the gradient of a fixed scalar loss for every parameter and the input
   through the kernel path (the Functions: kernel forwards, backwards
   through the scan kernels) against the plain path (the plain versions
   under autograd); per parameter ||g_kernel - g_plain|| / ||g_plain|| <=
   1e-3.
7. Training at full width: ``build(Config(), train=True)`` (seeded weights,
   adaLN and prompt perturbed as in phase 3) and ``Trainer.train_step`` on
   seeded synthetic (gt, ld) batches of 4 slices of 512^2 (2 x 2
   microbatches), made on the CPU: 1 warm-up step and 3 timed steps in fp32,
   then 2 in bf16.  Checks finite losses, a finite non-zero gradient for
   every trainable parameter, the parameters moved, the EMA as its schedule
   says (a copy at counter 0, untouched at counters 1-5), and the launches
   per step (18 ``ss2d_image_block``, 12 ``attn_block``, 24
   ``layer_norm_modulated``, 10 ``scan_image_forward``, 18 ``scan_forward``,
   18 ``scan_backward``); prints the step time, slices/s, peak memory and
   one profiled step.

8. Vanilla serving at full width: ``build`` of the vanilla DDPM path
   (``original_ddim_ddpm``, dim 64 x (1, 2, 4, 8), 512^2, seeded weights),
   one DDIM-250 sample at bs1 in fp32 through ``GaussianDiffusion.sample``
   (what ``Trainer.sample`` calls): shape, finite, in [0, 1], 250
   ``flash_fwd`` launches and no other; seconds per sample, peak memory and
   UNet forwards per second at bs1 and bs4 (median of 5); the same sample
   from the same generator seed through the plain path (``flash_attention``
   swapped for its plain version) must reach PSNR >= 40 dB.
9. Vanilla training at full width: ``Trainer.train_step`` of the vanilla
   path on seeded synthetic batches of 4 slices of 512^2 (2 x 2
   microbatches), checked as phase 7 (launches per step 2 / 2 / 2 of
   ``flash_fwd`` / ``flash_bwd_dq`` / ``flash_bwd_dkv`` and no other); then
   autograd through the bottleneck ``Attention`` at [2, 64, 64, 512], kernel
   path against plain path, per parameter and the input
   ||g_kernel - g_plain|| / ||g_plain|| <= 1e-3.
10. FoundDiff with both opt-in routes on (``FOUNDDIFF_GN=pallas``,
   ``FOUNDDIFF_UNIFIED=1``, set for the phase and restored after it): the
   requests of phase 3 on the same model with 9 ``ss2d_mamba_block``, 6
   ``attn_block``, 3 ``layer_norm_modulated`` and 10 / 10 GroupNorm launches
   per UNet forward and no ``ss2d_image_block``, PSNR >= 40 dB of the bs1
   request of seed 100 against phase 3's; autograd as phase 6 on the unified
   route (plain path: ``ss2d_mamba_block_plain``) and through one Block of
   each family on the GroupNorm route against the default route; training
   as phase 7 (1 warm-up and 3 timed fp32 steps) with 18 / 12 / 6 / 20 / 20
   / 10 / 18 / 18 launches per step (``ss2d_mamba_block``, ``attn_block``,
   ``layer_norm_modulated``, the GroupNorm pair, the three scans).
11. The vanilla path with ``FOUNDDIFF_GN=pallas``: phase 8's DDIM-250
   sample from the same generator seed (250 ``flash_fwd`` and 9,500 / 9,500
   GroupNorm launches, PSNR >= 40 dB against phase 8's sample), forwards/s
   at bs1 and bs4, training as phase 9 (3 timed fp32 steps, 2 / 2 / 2 flash
   and 76 / 76 GroupNorm launches per step), each printed beside phases 8
   and 9; then the 38 GroupNorm epilogues of a bs1 fp32 vanilla forward
   timed on each route against that forward's device-busy time.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
its path, phase 3 for the serving kernels, phase 10's requests for
``ss2d_mamba_block``, phase 7's timed steps for the scan kernels, phase 8's
sample for ``flash_fwd``, phase 11's for the GroupNorm pair and phase 9's
timed fp32 steps for the flash backward; the worst error of phase 2; and the
summed times of the calls of one bs1 bf16 UNet forward (serving kernels and
``ss2d_mamba_block``), one bs1 fp32 vanilla UNet forward (``flash_fwd``, the
GroupNorm pair) or one fp32 train step (the scan and flash backward
kernels)); the last is ``{"ok": true, "device": {...}}``.
A longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): device memory rate and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor bf16; fp32 CUDA cores
FP32_FLOPS = 67e12
# exponentials per SM per clock of the special function units (CUDA
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); main() sets SFU_EXP_PER_S from the card's SMs and maximum SM clock
SFU_PER_SM_CLOCK = 16
SFU_EXP_PER_S = None

# (H = W, C, d_state) of the nine MambaBlocks at 512^2 (dim 64, mults 1,2,4,8)
BLOCKS = {
    "down_0": (512, 64, 4), "down_1": (256, 64, 8), "down_2": (128, 128, 16),
    "down_3": (64, 256, 32), "mid": (64, 512, 32), "up_0": (64, 512, 32),
    "up_1": (128, 256, 16), "up_2": (256, 128, 8), "up_3": (512, 64, 4),
}
# Per element, |kernel - plain| <= ATOL + RTOL * max |plain - base| + ulp(plain),
# where base is the residual the kernel passes through (x_raw, x; none for the
# norm), so RTOL holds the part the kernel computes.  The ulp term is the
# output's own rounding: two sums a hair apart can round one ulp apart.
# fp32: the same arithmetic summed in another order.  bf16: both versions
# round to bf16 at the same points; an intermediate that lands near a
# rounding edge rounds one ulp apart and carries into the output, so RTOL is
# two bf16 ulps (2 * 2^-8) of the computed part's largest value.
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 8e-3)}
MANTISSA_BITS = {torch.float32: 23, torch.bfloat16: 7}
PSNR_GATE_DB = 40.0
# kernel-name groups of the profile, first match wins; the port's kernels
# live in namespace fd or in a file's top-level anonymous namespace (ATen's
# anonymous namespaces sit under at::native and are not the port's), and a
# profiler name starts with "void " for a template kernel, with the
# namespace for a plain one (gn_stats_reduce_kernel, image_scan_carry_kernel)
PROFILE_GROUPS = (
    ("port kernels", lambda n: n.startswith(("void fd::", "void (anonymous namespace)::",
                                              "fd::", "(anonymous namespace)::"))),
    ("cuDNN/cuBLAS convolutions and matmuls",
     lambda n: any(k in n for k in ("xmma", "cutlass", "conv2d", "gemm", "cudnn"))),
)

SOURCES = {
    "ss2d_image_block": ("founddiff_tpu_torch/csrc/ss2d_block.cu",
                         "founddiff_tpu/ops/ss2d_block.py:50"),
    "attn_block": ("founddiff_tpu_torch/csrc/attn_block.cu",
                   "founddiff_tpu/ops/attn_block.py:104"),
    "layer_norm_modulated": ("founddiff_tpu_torch/csrc/ln_mod.cu",
                             "founddiff_tpu/ops/norm_pallas.py:123"),
    "scan_forward": ("founddiff_tpu_torch/csrc/scan.cu",
                     "founddiff_tpu/ops/scan_pallas.py:269"),
    "scan_backward": ("founddiff_tpu_torch/csrc/scan.cu",
                      "founddiff_tpu/ops/scan_pallas.py:415"),
    "scan_image_forward": ("founddiff_tpu_torch/csrc/scan_image.cu",
                           "founddiff_tpu/ops/scan_pallas.py:895"),
    "flash_fwd": ("founddiff_tpu_torch/csrc/flash_attention.cu",
                  "founddiff_tpu/ops/attention_pallas.py:47"),
    "flash_bwd_dq": ("founddiff_tpu_torch/csrc/flash_attention.cu",
                     "founddiff_tpu/ops/attention_pallas.py:161"),
    "flash_bwd_dkv": ("founddiff_tpu_torch/csrc/flash_attention.cu",
                      "founddiff_tpu/ops/attention_pallas.py:201"),
    "gn_stats": ("founddiff_tpu_torch/csrc/groupnorm.cu",
                 "founddiff_tpu/ops/groupnorm_pallas.py:38"),
    "gn_apply": ("founddiff_tpu_torch/csrc/groupnorm.cu",
                 "founddiff_tpu/ops/groupnorm_pallas.py:50"),
    "ss2d_mamba_block": ("founddiff_tpu_torch/csrc/mamba_block.cu",
                         "founddiff_tpu/ops/experimental_unified.py:173 and :265"),
}
SERVING = ("ss2d_image_block", "attn_block", "layer_norm_modulated")
FLASH_BWD = ("flash_bwd_dq", "flash_bwd_dkv")
TRAIN_BATCH = 2  # slices per microbatch of Config().train
# launches per train step (2 microbatches), every other kernel 0: the JAX
# routing, 5 image-scan and 4 decimated-scan blocks in each SS2D backward
PER_STEP = {"ss2d_image_block": 18, "attn_block": 12, "layer_norm_modulated": 24,
            "scan_image_forward": 10, "scan_forward": 18, "scan_backward": 18}
# the vanilla UNet: one bottleneck Attention (64^2 at 512^2, so L = 4096,
# 4 heads of 32) per forward, its backward in each microbatch
VANILLA_PER_STEP = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
FLASH_HEADS, FLASH_D, FLASH_L = 4, 32, 4096
GRAD_REL_TOL = 1e-3
GN = ("gn_stats", "gn_apply")
GN_GROUPS = 8
# (H = W, C) -> TimeResnetBlocks per vanilla UNet forward at 512^2 (each two
# Blocks: block1 with the time scale/shift and no residual, block2 with the
# residual); the 10 ResnetBlocks of Config() (one Block with its residual
# each) take the same seven (H, C)
GN_BLOCKS = {(512, 64): 5, (256, 64): 2, (128, 128): 2, (64, 256): 2, (64, 512): 4,
             (128, 256): 2, (256, 128): 2}
# the two opt-in routes of phases 10 and 11, and their values there
ROUTES = {"FOUNDDIFF_GN": "pallas", "FOUNDDIFF_UNIFIED": "1"}
# launches per UNet forward on the default route (phase 3) and with both
# routes on (phase 10)
PER_FORWARD = {"ss2d_image_block": 9, "attn_block": 6, "layer_norm_modulated": 12}
PER_FORWARD_ROUTES = {"ss2d_mamba_block": 9, "attn_block": 6, "layer_norm_modulated": 3,
                      "gn_stats": 10, "gn_apply": 10}
# launches per train step with both routes on: the unified op in place of
# norm1 and the fused SS2D block, the same remat scans in its backward
PER_STEP_ROUTES = {"ss2d_mamba_block": 18, "attn_block": 12, "layer_norm_modulated": 6,
                   "gn_stats": 20, "gn_apply": 20, "scan_image_forward": 10,
                   "scan_forward": 18, "scan_backward": 18}
VANILLA_PER_STEP_GN = dict(VANILLA_PER_STEP, gn_stats=76, gn_apply=76)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops) -> tuple:
    """``ops``: [(count, rate)]; a rate names its unit (989e12: tensor cores
    in bf16, 67e12: fp32 CUDA cores, ``SFU_EXP_PER_S``: exponentials).  Work
    on one unit adds up; the units and the memory run at once, so the least
    time in ms is the largest of bytes over the memory rate and each unit's
    operations over its peak rate.  Returns it and its two parts."""
    per_unit = {}
    for n, r in ops:
        per_unit[r] = per_unit.get(r, 0) + n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / r for r, n in per_unit.items()) * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def ulp(t: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at each |t| (fp32 tensor; 0
    where t is 0)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp((t != 0).float(), (e - 1 - MANTISSA_BITS[dtype]).float())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --- phase 2 cases -------------------------------------------------------------


def _u(gen, shape, bound, dev):
    return (torch.rand(shape, generator=gen) * 2 - 1).mul_(bound).to(dev)


def _n(gen, shape, std, dev):
    return torch.randn(shape, generator=gen).mul_(std).to(dev)


def ln_case(B, H, C, affine, dtype, gen, dev):
    x = _n(gen, (B, H * H, C), 1.0, dev).add_(0.3).to(dtype)
    g = _n(gen, (C,), 0.1, dev).add_(1.0) if affine else None
    b = _n(gen, (C,), 0.1, dev) if affine else None
    ms, mt = _n(gen, (B, C), 0.2, dev), _n(gen, (B, C), 0.2, dev)
    args = (x, g, b, ms, mt)
    kw = dict(eps=1e-5 if affine else 1e-6)
    flops = 10 * x.numel()
    return args, kw, None, nbytes(x, g, b, ms, mt) + nbytes(x), [(flops, FP32_FLOPS)]


def ss2d_case(B, H, C0, N, dtype, gen, dev):
    D, R = 2 * C0, -(-C0 // 16)
    P = B * H * H
    dt = torch.exp(torch.rand((4, D), generator=gen) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3)).clamp_min(1e-4)
    args = (
        _n(gen, (B, H, H, C0), 1.0, dev).to(dtype),                     # x1
        torch.nn.functional.silu(_n(gen, (B, H, H, D), 1.0, dev)).to(dtype),  # xs
        _n(gen, (B, H, H, C0), 1.0, dev).to(dtype),                     # x_raw
        _u(gen, (C0, D), C0 ** -0.5, dev),                              # w_z
        _u(gen, (4, R + 2 * N, D), D ** -0.5, dev),                     # x_proj_weight
        _u(gen, (4, D, R), R ** -0.5, dev),                             # dt_projs_weight
        -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous().to(dev),
        torch.ones(4, D, device=dev),                                   # Dskip
        (dt + torch.log(-torch.expm1(-dt))).to(dev),                    # delta_bias
        _n(gen, (D,), 0.1, dev).add_(1.0), _n(gen, (D,), 0.1, dev),     # ln_g, ln_b
        _n(gen, (B, D), 0.2, dev).to(dtype),                            # local
        _u(gen, (D, C0), D ** -0.5, dev),                               # proj_w
        _n(gen, (B, C0), 0.3, dev),                                     # gate
    )
    kw = dict(dt_rank=R, d_state=N)
    io = torch.tensor([], dtype=dtype).element_size()
    # activations x1, xs, x_raw in and out at the io dtype; the products'
    # weights (w_z, x_proj, dt_projs, proj_w) at the io dtype the kernel reads
    # them in; A, Dskip, delta_bias, ln_g, ln_b and gate in fp32; local at io
    moved = io * P * (C0 + D + C0 + C0) \
        + io * (C0 * D + 4 * (R + 2 * N) * D + 4 * D * R + D * C0) \
        + 4 * (4 * D * N + 8 * D + 2 * D + B * C0) + io * B * D
    # delta through its rank-R factors (x_proj rows, then dt_projs), B and
    # C, z and out_proj, per pixel: each pixel is one step of one direction
    mm = 2 * P * (2 * D * R + 2 * N * D + 2 * C0 * D)
    scan = 6 * P * D * N
    return args, kw, args[2], moved, [(mm, PEAK_FLOPS[dtype]), (scan, FP32_FLOPS)]


def attn_case(B, H, C, dtype, gen, dev):
    heads = C // 32
    P = B * H * H
    args = (
        _n(gen, (B, H, H, C), 1.0, dev).add_(0.3).to(dtype),   # x
        _n(gen, (B, C), 0.2, dev), _n(gen, (B, C), 0.2, dev),  # mod_scale, mod_shift
        _n(gen, (B, C), 0.5, dev),                             # gate
        _u(gen, (3 * C, C, 1, 1), C ** -0.5, dev),             # qkv_w
        _u(gen, (3 * C, 1, 3, 3), 1 / 3, dev),                 # dw_w
        _n(gen, (heads, 1, 1), 0.3, dev).abs_().add_(0.5),     # temperature
        _u(gen, (C, C, 1, 1), C ** -0.5, dev),                 # proj_w
    )
    kw = dict(heads=heads, eps=1e-6)
    io = torch.tensor([], dtype=dtype).element_size()
    # x in and out, qkv_w and the taps at the io dtype the kernel reads them
    # in, temperature, proj_w and the modulation in fp32, gate at io
    moved = 2 * io * P * C + io * (3 * C * C + 27 * C + B * C) \
        + 4 * (heads + C * C + 2 * B * C)
    mm = 2 * P * (3 * C * C + C * C + 32 * C + 2 * C)
    other = 2 * P * 27 * C
    return args, kw, args[0], moved, [(mm, PEAK_FLOPS[dtype]), (other, FP32_FLOPS)]


def kernel_cases(B):
    """(kernel, label, per-forward count, case builder) at every distinct
    main-path shape at batch B; counts are calls per UNet forward."""
    cases = []
    ln1, ln2, ss, at = {}, {}, {}, {}
    for H, C, N in BLOCKS.values():
        ln1[(H, C)] = ln1.get((H, C), 0) + 1
        ss[(H, C, N)] = ss.get((H, C, N), 0) + 1
        if C >= 128:
            at[(H, C)] = at.get((H, C), 0) + 1
        else:
            ln2[(H, C)] = ln2.get((H, C), 0) + 1
    for (H, C), n in ln1.items():
        cases.append(("layer_norm_modulated", f"bs{B} norm1 {H}^2 C={C}", n,
                      lambda dt, g, d, H=H, C=C: ln_case(B, H, C, True, dt, g, d)))
    for (H, C), n in ln2.items():
        cases.append(("layer_norm_modulated", f"bs{B} norm2 {H}^2 C={C}", n,
                      lambda dt, g, d, H=H, C=C: ln_case(B, H, C, False, dt, g, d)))
    for (H, C, N), n in ss.items():
        cases.append(("ss2d_image_block", f"bs{B} {H}^2 C0={C} D={2 * C} N={N}", n,
                      lambda dt, g, d, H=H, C=C, N=N: ss2d_case(B, H, C, N, dt, g, d)))
    for (H, C), n in at.items():
        cases.append(("attn_block", f"bs{B} {H}^2 C={C} heads={C // 32}", n,
                      lambda dt, g, d, H=H, C=C: attn_case(B, H, C, dt, g, d)))
    return cases


def _dt_bias(gen, K, D, dev):
    """The S4D dt-bias init of the factory (softplus^-1 of dt in [1e-3, 0.1])."""
    dt = torch.exp(torch.rand((K, D), generator=gen) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3)).clamp_min(1e-4)
    return (dt + torch.log(-torch.expm1(-dt))).to(dev)


def _scan_operands(H, C, N, dtype, gen, dev):
    """The decimated scan's operands of one block at the training batch:
    u is a post-silu activation, delta/B/C projections of it."""
    D, L = 2 * C, (H // 2) ** 2
    R = -(-C // 16)
    u = torch.nn.functional.silu(_n(gen, (TRAIN_BATCH, 4, L, D), 1.0, dev))
    delta = _n(gen, (TRAIN_BATCH, 4, L, D), R ** -0.5, dev)
    Bm, Cm = (_n(gen, (TRAIN_BATCH, 4, L, N), 0.5, dev) for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous().to(dev)
    return (u.to(dtype), delta.to(dtype), A, Bm.to(dtype), Cm.to(dtype),
            torch.ones(4, D, device=dev), _dt_bias(gen, 4, D, dev))


def scan_fwd_case(H, C, N, dtype, gen, dev):
    from founddiff_tpu_torch.ops.scan import scan_chunk

    args = _scan_operands(H, C, N, dtype, gen, dev)
    u, _, _, Bm = args[:4]
    G, L, D = TRAIN_BATCH * 4, u.shape[2], u.shape[3]
    hb_bytes = 4 * G * -(-L // scan_chunk(N)) * N * D
    # u, delta, B, C in, y out at the io dtype; A, Dskip, bias in and
    # h_bounds out in fp32; per step per channel about 6N + 5 fp32 operations
    moved = nbytes(*args) + nbytes(u) + hb_bytes
    return args, {}, None, moved, [(G * L * D * (6 * N + 5), FP32_FLOPS)]


def scan_bwd_case(H, C, N, dtype, gen, dev):
    from founddiff_tpu_torch.ops.scan import scan_chunk, scan_forward_plain

    fwd = _scan_operands(H, C, N, dtype, gen, dev)
    _, hb = scan_forward_plain(*fwd, scan_chunk(N))
    dy = _n(gen, fwd[0].shape, 1.0, dev).to(dtype)
    u, A = fwd[0], fwd[2]
    G, L, D = TRAIN_BATCH * 4, u.shape[2], u.shape[3]
    # the forward's inputs, h_bounds and dy in; gu, gdelta, gB, gC at the io
    # dtype and gA, gD, gbias in fp32 out.  Operations: the adjoint and the
    # gradient terms, about 12N + 10 per step per channel (the replay of the
    # states from h_bounds is not counted)
    moved = nbytes(*fwd, hb, dy) + nbytes(u, u, fwd[3], fwd[4], A, fwd[5], fwd[6])
    return (*fwd, hb, dy), {}, None, moved, [(G * L * D * (12 * N + 10), FP32_FLOPS)]


def scan_image_case(H, C, N, dtype, gen, dev):
    D, R = 2 * C, -(-C // 16)
    P = TRAIN_BATCH * H * H
    x = torch.nn.functional.silu(_n(gen, (TRAIN_BATCH, H, H, D), 1.0, dev)).to(dtype)
    xw = _u(gen, (4, R + 2 * N, D), D ** -0.5, dev)
    dtw = _u(gen, (4, D, R), R ** -0.5, dev)
    w_delta = torch.einsum("krd,ker->kde", xw[:, :R], dtw).to(dtype)
    w_b = xw[:, R:R + N].transpose(1, 2).contiguous().to(dtype)
    w_c = xw[:, R + N:].transpose(1, 2).contiguous().to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous().to(dev)
    args = (x, w_delta, w_b, w_c, A, torch.ones(4, D, device=dev), _dt_bias(gen, 4, D, dev))
    # x in and ys out at the io dtype, the folded weights at the io dtype;
    # delta through its rank-R factors (x_proj rows, then dt_projs), B and C,
    # per pixel (each pixel is one step of one direction), on the tensor
    # cores in bf16 and the CUDA cores in fp32; the scan in fp32
    moved = nbytes(*args) + nbytes(x)
    mm = 2 * P * (2 * D * R + 2 * N * D)
    return args, {}, None, moved, [(mm, PEAK_FLOPS[dtype]), (P * D * (6 * N + 5), FP32_FLOPS)]


def train_cases():
    """(kernel, label, calls per train step, case builder) of the scan kernels
    at every distinct shape of the 512^2 training path."""
    from founddiff_tpu_torch.ops.scan import image_scan_vmem_ok

    dec, img = {}, {}
    for H, C, N in BLOCKS.values():
        dec[(H, C, N)] = dec.get((H, C, N), 0) + 2
        if image_scan_vmem_ok(H, H, 2 * C, N):
            img[(H, C, N)] = img.get((H, C, N), 0) + 2
    cases = []
    for (H, C, N), n in dec.items():
        label = f"B{TRAIN_BATCH}x4 L={(H // 2) ** 2} D={2 * C} N={N}"
        cases.append(("scan_forward", label, n,
                      lambda dt, g, d, H=H, C=C, N=N: scan_fwd_case(H, C, N, dt, g, d)))
        cases.append(("scan_backward", label, n,
                      lambda dt, g, d, H=H, C=C, N=N: scan_bwd_case(H, C, N, dt, g, d)))
    for (H, C, N), n in img.items():
        cases.append(("scan_image_forward", f"B{TRAIN_BATCH} {H}^2 D={2 * C} N={N}", n,
                      lambda dt, g, d, H=H, C=C, N=N: scan_image_case(H, C, N, dt, g, d)))
    return cases


def flash_case(kname, B, Lq, Lk, dtype, gen, dev):
    """The flash kernels' operands at the bottleneck's 4 heads of 32; the
    backward's lse and D from the plain forward.  Operations: 4d per (i, j)
    forward, 6d for dq and 8d for dk/dv (the products, at the peak rate of
    the io dtype's unit) and one exponential per (i, j) on the SFUs."""
    from founddiff_tpu_torch.ops.flash_attention import flash_fwd_plain

    H, d = FLASH_HEADS, FLASH_D
    G, scale = B * H, d ** -0.5
    q = _n(gen, (B, H, Lq, d), 1.0, dev).to(dtype)
    k, v = (_n(gen, (B, H, Lk, d), 1.0, dev).to(dtype) for _ in range(2))
    pairs = G * Lq * Lk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kname == "flash_fwd":
        args = (q, k, v, scale)
        moved, flops = nbytes(q, k, v) + nbytes(q) + 4 * G * Lq, 4 * pairs * d
        library = lambda: sdpa(q, k, v, scale=scale)
    else:
        do = _n(gen, (B, H, Lq, d), 1.0, dev).to(dtype)
        o, lse = flash_fwd_plain(q, k, v, scale)
        dcap = (do.float() * o.float()).sum(-1).reshape(G, Lq)
        args = (q, k, v, do, lse, dcap, scale)
        outs = (q,) if kname == "flash_bwd_dq" else (k, v)
        moved = nbytes(q, k, v, do, lse, dcap) + nbytes(*outs)
        flops = (6 if kname == "flash_bwd_dq" else 8) * pairs * d
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(*leaves, scale=scale)
        # SDPA's backward gives dq, dk and dv in one call: the yardstick of both rows
        library = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    work = [(flops, PEAK_FLOPS[dtype]), (pairs, SFU_EXP_PER_S)]
    return args, {}, None, moved, work, library


def flash_cases():
    """(batch, kernel, label, calls per forward or step, builder) of the
    flash kernels: the forward at bs1 (one call per vanilla UNet forward when
    serving) and at the training microbatch of 2, the backward at 2 (two
    calls per train step), and all three at a ragged Lq 1000 / Lk 777 that
    the main path does not run (0 calls)."""
    L = FLASH_L
    spec = [(1, "flash_fwd", L, L, 1), (TRAIN_BATCH, "flash_fwd", L, L, 0)]
    spec += [(TRAIN_BATCH, k, L, L, 2) for k in FLASH_BWD]
    spec += [(TRAIN_BATCH, k, 1000, 777, 0) for k in ("flash_fwd",) + FLASH_BWD]
    return [(B, k, f"B{B} H{FLASH_HEADS} Lq={Lq} Lk={Lk} d={FLASH_D}", n,
             lambda dt, g, d, k=k, B=B, Lq=Lq, Lk=Lk: flash_case(k, B, Lq, Lk, dt, g, d))
            for B, k, Lq, Lk, n in spec]


def _group_norm_library(x4, gen, dev):
    """The yardstick of the GroupNorm pair (stats and apply together):
    ``F.group_norm`` on a contiguous NCHW copy of the NHWC activation, made
    before the timing, so that no layout copy is timed.  It covers the
    normalisation and a per-channel affine but not the per-image fold, the
    silu or the residual."""
    C = x4.shape[-1]
    w, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
    w, b = w.to(x4.dtype), b.to(x4.dtype)
    nchw = x4.permute(0, 3, 1, 2).contiguous()
    return lambda: torch.nn.functional.group_norm(nchw, GN_GROUPS, w, b, 1e-5)


def gn_stats_case(B, H, C, dtype, gen, dev):
    x = _n(gen, (B, H * H, C), 1.5, dev).add_(0.3).to(dtype)
    # x read once, [B, 2, C] fp32 written; a sum and a square-add per element
    moved = nbytes(x) + 4 * 2 * B * C
    # no library row of its own: the pair's F.group_norm stands in gn_apply's
    return (x,), {}, None, moved, [(3 * x.numel(), FP32_FLOPS)]


def gn_apply_case(B, H, C, res, dtype, gen, dev):
    """gn_apply as the Blocks call it: with the residual (block2, the
    ResnetBlocks) or, without one, with the time scale/shift folded into the
    per-image affine (block1)."""
    from founddiff_tpu_torch.ops.groupnorm import gn_stats_plain, group_stats

    x = _n(gen, (B, H * H, C), 1.5, dev).add_(0.3).to(dtype)
    mean, rstd = group_stats(gn_stats_plain(x), H * H, GN_GROUPS, 1e-5)
    g, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
    ms, mt = (_n(gen, (B, C), 0.2, dev) for _ in range(2))
    if res:
        g, b = g.expand(B, C).contiguous(), b.expand(B, C).contiguous()
    else:
        g, b = g * (ms + 1.0), b * (ms + 1.0) + mt
    r = _n(gen, (B, H * H, C), 1.0, dev).to(dtype) if res else None
    # x (and the residual) read, y written at the io dtype, four [B, C] fp32;
    # per element about 10 fp32 operations and one exponential
    moved = nbytes(x, r) + nbytes(x) + 4 * 4 * B * C
    work = [(10 * x.numel(), FP32_FLOPS), (x.numel(), SFU_EXP_PER_S)]
    return ((x, mean, rstd, g, b, r), {}, r, moved, work,
            _group_norm_library(x.view(B, H, H, C), gen, dev))


def mamba_case(B, H, C0, N, dtype, gen, dev):
    D, R = 2 * C0, -(-C0 // 16)
    P = B * H * H
    dt = torch.exp(torch.rand((4, D), generator=gen) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3)).clamp_min(1e-4)
    kw = dict(
        x=_n(gen, (B, H, H, C0), 1.0, dev).add_(0.2).to(dtype),
        ln_scale=_n(gen, (C0,), 0.1, dev).add_(1.0), ln_bias=_n(gen, (C0,), 0.1, dev),
        mod_scale=_n(gen, (B, C0), 0.2, dev), mod_shift=_n(gen, (B, C0), 0.2, dev),
        in_proj_w=_u(gen, (2 * D, C0), C0 ** -0.5, dev),
        dw_kernel=_u(gen, (D, 1, 3, 3), 1 / 3, dev), dw_bias=_u(gen, (D,), 1 / 3, dev),
        x_proj_weight=_u(gen, (4, R + 2 * N, D), D ** -0.5, dev),
        dt_projs_weight=_u(gen, (4, D, R), R ** -0.5, dev),
        A=-torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous().to(dev),
        Dskip=torch.ones(4, D, device=dev), delta_bias=(dt + torch.log(-torch.expm1(-dt))).to(dev),
        out_ln_g=_n(gen, (D,), 0.1, dev).add_(1.0), out_ln_b=_n(gen, (D,), 0.1, dev),
        local=_n(gen, (B, D), 0.2, dev).to(dtype), proj_w=_u(gen, (C0, D), D ** -0.5, dev),
        gate=_n(gen, (B, C0), 0.3, dev), d_inner=D, dt_rank=R, d_state=N)
    io = torch.tensor([], dtype=dtype).element_size()
    # x in and out at the io dtype; the products' weights (in_proj, x_proj,
    # dt_projs, out_proj) and the taps at the io dtype the kernel reads them
    # in; norm1's affine, the modulation, dw bias, A, Dskip, delta_bias, the
    # out_norm affine and gate in fp32; local at io
    moved = io * P * 2 * C0 \
        + io * (2 * D * C0 + 9 * D + 4 * (R + 2 * N) * D + 4 * D * R + D * C0) \
        + 4 * (2 * C0 + 2 * B * C0 + D + 4 * D * N + 8 * D + 2 * D + B * C0) + io * B * D
    # multiply-adds per pixel on the products' unit: in_proj's x and z halves
    # (C0 x D each) and out_proj (D x C0), delta through its rank-R factors,
    # B and C; in fp32 the depthwise 3x3 (9 multiply-adds per channel), the
    # LayerNorms and the scan
    mm = 2 * P * (3 * C0 * D + 2 * D * R + 2 * N * D)
    fp32 = P * (18 * D + 5 * C0 + 5 * D + 6 * D * N)
    return (), kw, kw["x"], moved, [(mm, PEAK_FLOPS[dtype]), (fp32, FP32_FLOPS)]


def route_cases(B):
    """(kernel, label, count, builder) of the two opt-in routes at batch B:
    the GroupNorm pair at every (H, C) of GN_BLOCKS (counts: calls per bs1
    vanilla UNet forward) and the unified op at every MambaBlock shape of
    BLOCKS (counts: calls per FoundDiff UNet forward); batches 1 and 4 are
    the serving batches, TRAIN_BATCH the microbatch of the train steps."""
    cases = []
    for (H, C), n in GN_BLOCKS.items():
        cases.append(("gn_stats", f"bs{B} {H}^2 C={C}", 2 * n,
                      lambda dt, g, d, H=H, C=C: gn_stats_case(B, H, C, dt, g, d)))
        for res in (True, False):
            cases.append(("gn_apply", f"bs{B} {H}^2 C={C} {'res' if res else 'scale/shift'}",
                          n, lambda dt, g, d, H=H, C=C, res=res: gn_apply_case(
                              B, H, C, res, dt, g, d)))
    ss = {}
    for H, C, N in BLOCKS.values():
        ss[(H, C, N)] = ss.get((H, C, N), 0) + 1
    for (H, C, N), n in ss.items():
        cases.append(("ss2d_mamba_block", f"bs{B} {H}^2 C0={C} D={2 * C} N={N}", n,
                      lambda dt, g, d, H=H, C=C, N=N: mamba_case(B, H, C, N, dt, g, d)))
    return cases


def compare(got, want, base, dtype):
    """Per element |got - want| <= atol + rtol * max|want - base| + ulp, by
    each output's own dtype.  Returns (max error, worst error past one ulp,
    computed-part max, tolerance, ok) over every output of a tuple."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = excess = scale_all = tol_all = 0.0
    ok = True
    for g, w in zip(got, want):
        dt = g.dtype
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        computed = w if base is None else w - base.float()
        scale = computed.abs().max().item()
        out_ulp = ulp(torch.maximum(g.abs(), w.abs()), dt)
        atol, rtol = TOL[dt]
        tol = atol + rtol * scale
        ex = (diff - out_ulp).clamp_min(0).max().item()
        ok = ok and bool(torch.isfinite(g).all()) and ex <= tol
        if ex / tol >= excess / max(tol_all, 1e-30):
            excess, tol_all, scale_all = ex, tol, scale
        err = max(err, diff.max().item())
    return err, excess, scale_all, tol_all, ok


def check_kernels(ops, cases):
    """``cases``: (batch, kernel, label, calls per forward or step, builder)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    rows, failed = [], []
    for batch, kname, label, count, make in cases:
        kernel, plain = ops[kname]
        for dtype in (torch.float32, torch.bfloat16):
            # a builder may add a sixth item: one PyTorch call computing the same function
            args, kw, base, moved, work, *library = make(dtype, gen, dev)
            got = kernel(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err, excess, scale, tol, ok = compare(got, want, base, dtype)
            ms = cuda_ms(lambda: kernel(*args, **kw))
            pms = cuda_ms(lambda: plain(*args, **kw))
            lms = cuda_ms(library[0]) if library else None
            bms, t_bytes, t_ops = bound_ms(moved, work)
            by = "bytes" if t_bytes >= t_ops else "operations"
            row = dict(kernel=kname, shape=label, batch=batch,
                       dtype=str(dtype).replace("torch.", ""),
                       per_forward=count, max_abs_err=err, err_past_ulp=excess,
                       max_abs_computed=scale, tol=tol, ok=ok, ms=ms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bytes_ms=t_bytes, ops_ms=t_ops,
                       bound_by=by)
            rows.append(row)
            lib = "" if lms is None else f"  library {lms:.4f} ms"
            log(f"[kernel] {kname:21s} {label:32s} {row['dtype']:8s} err {err:.3e}, "
                f"past 1 ulp {excess:.3e} (tol {tol:.3e}, computed part max {scale:.3e}) "
                f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
                f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by}){lib}")
            if not ok:
                failed.append(f"{kname} {label} {row['dtype']}")
            del args, got, want, library
        torch.cuda.empty_cache()
    return rows, failed


# --- phases 3 and 4 ------------------------------------------------------------


def perturb_gates(model, seed: int) -> None:
    """adaLN and prompt from N(0, 0.02): zero adaLN gates would make every
    MambaBlock the identity and hide a wrong kernel."""
    from founddiff_tpu_torch.models.ss2d import MambaBlock

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        tensors = []
        for mod in model.modules():
            if isinstance(mod, MambaBlock):
                tensors += [mod.adaLN_modulation[1].weight, mod.adaLN_modulation[1].bias]
        tensors.append(model.unet0.prompt)
        for t in tensors:
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)) * 0.02))


def profile_device(run, tag: str, top: int = 25):
    """Device time by kernel name over one call of ``run``, and the device's
    busy share of its wall time (kernels run on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [dict(name=e.key[:120], calls=e.count, ms=e.self_device_time_total / 1e3)
            for e in kernels]
    groups = {}
    for r in rows:
        g = next((name for name, match in PROFILE_GROUPS if match(r["name"])),
                 "other PyTorch kernels")
        calls, ms = groups.get(g, (0, 0.0))
        groups[g] = (calls + r["calls"], ms + r["ms"])
    log(f"[profile {tag}] wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(r['calls'] for r in rows)} kernel launches")
    for g, (calls, ms) in groups.items():
        log(f"[profile {tag}] group {g}: {ms:.3f} ms in {calls} launches")
    for r in rows[:top]:
        log(f"[profile {tag}] {r['ms']:9.3f} ms {r['calls']:6d}x  {r['name']}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, groups=groups, kernels=rows)


def check_autograd(ss2d_model, plain, wrappers, tag="autograd"):
    """Phases 6 and 10: d(sum(out * w))/d(x, every parameter) of one
    MambaBlock at 256^2 C 128 and one at 64^2 C 512, batch 2, fp32, through
    the kernel path and through the plain path (the wrappers in ``plain``
    swapped in ``models/ss2d.py`` for their plain versions, which autograd
    differentiates directly).  On the default route the first block takes
    the image scan and the second the decimated scan in its backward."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.ss2d import MambaBlock

    dev = torch.device("cuda")
    result, failed = {}, []
    for H, C, N in ((256, 128, 8), (64, 512, 32)):
        gen = torch.Generator().manual_seed(H + C)
        block = MambaBlock(C, N, time_dim=256)
        init_params(block, gen)
        with torch.no_grad():  # live adaLN gates, as in phase 3
            for p in (block.adaLN_modulation[1].weight, block.adaLN_modulation[1].bias):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        block = block.to(dev).requires_grad_(True)
        x, w = _n(gen, (2, H, H, C), 1.0, dev), _n(gen, (2, H, H, C), 1.0, dev)
        c, t = _n(gen, (2, 1, 256), 1.0, dev), _n(gen, (2, 256), 1.0, dev)
        names = ["x"] + [n for n, _ in block.named_parameters()]

        def grads():
            xi = x.clone().requires_grad_(True)
            loss = (block(xi, c, t) * w).sum()
            return torch.autograd.grad(loss, [xi] + list(block.parameters()))

        for fn in wrappers.values():
            fn.launches = 0
        g_kernel = grads()
        used = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        saved = {n: getattr(ss2d_model, n) for n in plain}
        try:
            for n, fn in plain.items():
                setattr(ss2d_model, n, fn)
            g_plain = grads()
        finally:
            for n, fn in saved.items():
                setattr(ss2d_model, n, fn)
        label = f"MambaBlock {H}^2 C={C} N={N}"
        result[label] = grad_errors(tag, label, names, g_kernel, g_plain, used, failed)
        del block, g_kernel, g_plain
    if failed:
        raise AssertionError(f"{tag}: kernel path disagrees with the plain path: {failed}")
    return result


def grad_errors(tag, label, names, g_kernel, g_plain, used, failed):
    """Per gradient ||g_kernel - g_plain|| / ||g_plain||; logs the worst and
    appends every one past GRAD_REL_TOL to ``failed``."""
    rel = {}
    for n, a, b in zip(names, g_kernel, g_plain):
        finite = bool(torch.isfinite(a).all())
        rel[n] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item() if finite else math.inf
    worst = max(rel, key=rel.get)
    log(f"[{tag}] {label}: {len(rel)} gradients, worst relative error {rel[worst]:.3e} "
        f"({worst}), gate {GRAD_REL_TOL}; kernel launches {used}")
    failed += [f"{label} {n}" for n, r in rel.items() if not r <= GRAD_REL_TOL]
    return dict(worst=rel[worst], worst_name=worst, launches=used, rel=rel)


@contextlib.contextmanager
def routes_on(**values):
    """``os.environ`` set to ``values`` for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_gn_autograd(wrappers):
    """Phase 10: d(sum(out * w))/d(x, every parameter, the scale/shift) of one
    Block of each family at [2, 128, 128, 128], fp32: the FoundDiff
    ResnetBlock's (with its residual) and the vanilla block1's (with the
    time scale/shift), on the GroupNorm route (the two kernels forward, the
    plain composition backward) against the default route (the plain
    composition, which autograd differentiates directly)."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.blocks import Block

    dev = torch.device("cuda")
    result, failed = {}, []
    for family, scale_shift in (("FoundDiff ResnetBlock", False), ("vanilla block1", True)):
        gen = torch.Generator().manual_seed(128 + scale_shift)
        block = Block(128, 128)
        init_params(block, gen)
        with torch.no_grad():  # no identity affine
            block.norm.weight.add_(torch.randn(128, generator=gen) * 0.1)
            block.norm.bias.add_(torch.randn(128, generator=gen) * 0.1)
        block = block.to(dev).requires_grad_(True)
        x, w = _n(gen, (2, 128, 128, 128), 1.0, dev), _n(gen, (2, 128, 128, 128), 1.0, dev)
        ss = [_n(gen, (2, 128), 0.2, dev) for _ in range(2)] if scale_shift else []
        names = (["x", "mod_scale", "mod_shift"][:1 + len(ss)]
                 + [n for n, _ in block.named_parameters()])

        def grads():
            xi = x.clone().requires_grad_(True)
            si = [t.clone().requires_grad_(True) for t in ss]
            out = block(xi, scale_shift=tuple(si)) if si else block(xi, residual=xi)
            return torch.autograd.grad((out * w).sum(), [xi] + si + list(block.parameters()))

        for fn in wrappers.values():
            fn.launches = 0
        with routes_on(FOUNDDIFF_GN=ROUTES["FOUNDDIFF_GN"]):
            g_kernel = grads()
        used = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
        if used != {"gn_stats": 1, "gn_apply": 1}:
            raise AssertionError(f"{family} autograd: kernel launches {used}")
        g_plain = grads()
        label = f"{family} [2, 128, 128, 128]"
        result[label] = grad_errors("autograd routes", label, names, g_kernel, g_plain, used,
                                    failed)
    if failed:
        raise AssertionError(f"GroupNorm autograd: kernel path disagrees with the plain path: "
                             f"{failed}")
    return result


def train_full_width(wrappers, card, cfg, per_step, tag, full=True):
    """Phases 7, 9, 10 and 11: ``Trainer.train_step`` of ``cfg`` on the card.
    ``per_step``: the launches per step of the path's kernels (every other
    kernel 0).  ``full=False`` (the routed phases) takes the warm-up and the
    three timed fp32 steps only: no profiled step and no bf16 steps."""
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.train.trainer import Trainer

    cfg.train.checkpoint_folder = os.path.join(REPO, "chiprun_out", tag.replace(" ", "_"))
    diffusion, model = build(cfg, device="cuda", seed=0, train=True)
    if not cfg.model.original_ddim_ddpm:
        perturb_gates(model, seed=0)
    trainer = Trainer(diffusion, model, cfg)
    B = cfg.train.train_batch_size * cfg.train.gradient_accumulate_every
    S = cfg.diffusion.image_size
    gen = torch.Generator().manual_seed(0)

    def batch():  # synthetic seeded (gt, ld) slices in [0, 1]; no dataset is in the repo
        # (the vanilla path trains on gt alone)
        gt = torch.rand((B, S, S, 1), generator=gen)
        return gt, (gt + 0.1 * torch.randn((B, S, S, 1), generator=gen)).clamp(0, 1)

    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    nonzero, bad = set(), set()

    def look_at_grads():
        for n, p in trainable:
            if p.grad is None:
                continue
            if not bool(torch.isfinite(p.grad).all()):
                bad.add(n)
            elif float(p.grad.abs().max()) > 0:
                nonzero.add(n)

    def run(mp, b, counts, check=True):
        cfg.train.mixed_precision = mp
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = trainer.train_step(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for k, fn in wrappers.items():
            counts.setdefault(k, []).append(fn.launches)
        if check:
            look_at_grads()
        return losses, dt

    warm, _ = run("no", batch(), {})  # EMA counter 0: a copy
    after_one = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    counts, losses, t_fp32, t_bf16 = {}, [warm], [], []
    for _ in range(3):
        loss, dt = run("no", batch(), counts)
        losses.append(loss)
        t_fp32.append(dt)
    launches = {k: sum(v) for k, v in counts.items()}  # the main path's timed steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = None
    if full:
        b = batch()
        prof = profile_device(lambda: run("no", b, {}, check=False), f"{tag} step fp32")
        for _ in range(2):
            loss, dt = run("bf16", batch(), counts)
            losses.append(loss)
            t_bf16.append(dt)
    for k in wrappers:
        n = per_step.get(k, 0)
        if any(c != n for c in counts[k]):
            raise AssertionError(f"{tag}: {k} launches per train step {counts[k]}, want {n}")
    if not all(math.isfinite(v) for l in losses for v in l):
        raise AssertionError(f"non-finite training loss: {losses}")
    missing = sorted({n for n, _ in trainable} - nonzero)
    if bad or missing:
        raise AssertionError(f"gradients: non-finite {sorted(bad)}, never non-zero {missing}")
    ema = dict(trainer.ema.named_parameters())
    for n, p in model.named_parameters():
        if not torch.equal(ema[n], after_one[n]):
            raise AssertionError(f"EMA {n} changed at counters 1-{trainer.ema_step - 1}")
        if p.requires_grad == torch.equal(p.detach(), after_one[n]):
            raise AssertionError(f"{n}: trainable {p.requires_grad}, moved "
                                 f"{not torch.equal(p.detach(), after_one[n])}")
    step_s = statistics.median(t_fp32)
    log(f"[{tag}] {type(model).__name__} {S}^2, {B} slices per step "
        f"({cfg.train.train_batch_size} x {cfg.train.gradient_accumulate_every}): "
        f"losses {[round(l[0], 6) for l in losses]}")
    bf16 = ""
    if t_bf16:
        step_bf16 = t_bf16[-1]  # the first bf16 step also runs the first bf16 convolutions
        bf16 = (f"bf16 step {step_bf16:.4f} s (the last of {[round(t, 4) for t in t_bf16]}), "
                f"{B / step_bf16:.3f} slices/s; ")
    log(f"[{tag}] fp32 step {step_s:.4f} s (median of {len(t_fp32)}: "
        f"{[round(t, 4) for t in t_fp32]}), {B / step_s:.3f} slices/s; {bf16}"
        f"peak memory {peak_gib:.2f} GiB over the fp32 steps [{card}]")
    log(f"[{tag}] launches per step {dict((k, v[0]) for k, v in counts.items() if v[0])}; "
        f"{len(nonzero)} of {len(trainable)} trainable parameters with a non-zero gradient; "
        f"EMA a copy of step 1 at counter {trainer.ema_step}")
    return dict(step_s=t_fp32, step_bf16_s=t_bf16, slices_per_s=B / step_s,
                slices_per_s_bf16=B / t_bf16[-1] if t_bf16 else None,
                peak_memory_gib=peak_gib, losses=losses, launches=launches, per_step=counts,
                profile=prof, size=S, batch=B)


def vanilla_config():
    """The vanilla DDPM path at its shipped size (``train.py:72-83`` with
    ``--original_ddim_ddpm``): dim 64 x (1, 2, 4, 8), 512^2, one channel, no
    conditioning; T = 1000, DDIM over 250 steps with eta 1."""
    from founddiff_tpu_torch.config import Config

    cfg = Config()
    cfg.model.original_ddim_ddpm = True
    cfg.model.condition = False
    return cfg


def vanilla_serving(wrappers, card, want, tag="vanilla", reference=None):
    """Phases 8 and 11: one DDIM-250 sample at bs1 in fp32 through
    ``GaussianDiffusion.sample``, UNet forwards per second, and the numerics
    gate: against the same sample through the plain path (``flash_attention``
    swapped for its plain version), or against ``reference`` (phase 11: phase
    8's sample from the same generator seed).  ``want``: the sample's
    launches of the path's kernels (every other kernel 0).  Returns the
    record and the sample."""
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.models import blocks as blocks_mod
    from founddiff_tpu_torch.ops.flash_attention import flash_attention_plain

    cfg = vanilla_config()
    diffusion, model = build(cfg, device="cuda", seed=0)
    S, steps = cfg.diffusion.image_size, diffusion.sampling_timesteps
    log(f"[{tag}] build(vanilla) on cuda: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
        f"DDIM-{steps} of T = {diffusion.num_timesteps}, eta {diffusion.ddim_sampling_eta}")

    def forwards_per_s(B):
        x = torch.randn((B, S, S, 1), generator=torch.Generator().manual_seed(B)).cuda()
        t = torch.full((B,), 500, device="cuda")

        def run():
            with torch.no_grad():
                model(x, t)
            torch.cuda.synchronize()

        run()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return 1.0 / statistics.median(times), times

    def sample(seed):
        out = diffusion.sample(batch_size=1, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return out

    fps1, t_fwd1 = forwards_per_s(1)  # also the warm-up of the sample's forwards
    x1 = torch.randn((1, S, S, 1), generator=torch.Generator().manual_seed(1)).cuda()
    t1 = torch.full((1,), 500, device="cuda")
    with torch.no_grad():
        prof = profile_device(lambda: model(x1, t1), f"{tag} forward bs1")
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = sample(0)
    t_sample = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: want.get(k, 0) for k in wrappers}
    if launches != want:
        raise AssertionError(f"{tag} DDIM-{steps}: launches {launches}, want {want}")
    if out.shape != (1, S, S, 1) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bad sample {tuple(out.shape)} finite={torch.isfinite(out).all()}")
    if float(out.min()) < 0.0 or float(out.max()) > 1.0:
        raise AssertionError("sample leaves [0, 1]")
    fps4, t_fwd4 = forwards_per_s(4)
    t_plain = None
    if reference is None:
        saved = blocks_mod.flash_attention
        try:
            blocks_mod.flash_attention = flash_attention_plain
            t0 = time.perf_counter()
            reference = sample(0)
            t_plain = time.perf_counter() - t0
        finally:
            blocks_mod.flash_attention = saved
        against = f"plain path {t_plain:.2f} s"
    else:
        against = "phase 8's sample (the default route)"
    gate_db = psnr(out, reference)
    max_diff = float((out - reference).abs().max())
    log(f"[{tag}] DDIM-{steps} {S}^2 bs1 fp32: {t_sample:.3f} s per sample, peak memory "
        f"{peak_gib:.2f} GiB; launches {dict((k, n) for k, n in launches.items() if n)}; "
        f"UNet forwards/s bs1 {fps1:.3f} (s {[round(t, 4) for t in t_fwd1]}), bs4 "
        f"{fps4:.3f} (s {[round(t, 4) for t in t_fwd4]}) [{card}]")
    log(f"[{tag} gate] DDIM-{steps} {S}^2 bs1 fp32 against {against}: PSNR "
        f"{gate_db:.2f} dB (gate {PSNR_GATE_DB}), max |diff| {max_diff:.3e}")
    if not (math.isfinite(max_diff) and gate_db >= PSNR_GATE_DB):
        raise AssertionError(f"{tag} numerics gate failed: {gate_db:.2f} dB")
    return dict(launches=launches, steps=steps, size=S, sample_s=t_sample, plain_s=t_plain,
                profile=prof, peak_memory_gib=peak_gib, forwards_per_s_bs1=fps1,
                forwards_per_s_bs4=fps4, forward_s_bs1=t_fwd1, forward_s_bs4=t_fwd4,
                psnr_db=gate_db, max_abs_diff=max_diff), out


def check_attention_autograd(wrappers):
    """Phase 9's autograd check: d(sum(out * w))/d(x, every parameter) of the
    bottleneck ``Attention`` (dim 512, 4 heads of 32) at [2, 64, 64, 512],
    fp32, through the kernel path (flash forward and both backward kernels)
    and the plain path (``flash_attention`` swapped for its plain version,
    which autograd differentiates directly)."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models import blocks as blocks_mod
    from founddiff_tpu_torch.ops.flash_attention import flash_attention_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(64)
    attn = blocks_mod.Attention(512)
    init_params(attn, gen)
    attn = attn.to(dev).requires_grad_(True)
    x, w = _n(gen, (2, 64, 64, 512), 1.0, dev), _n(gen, (2, 64, 64, 512), 1.0, dev)
    names = ["x"] + [n for n, _ in attn.named_parameters()]

    def grads():
        xi = x.clone().requires_grad_(True)
        loss = (attn(xi) * w).sum()
        return torch.autograd.grad(loss, [xi] + list(attn.parameters()))

    for fn in wrappers.values():
        fn.launches = 0
    g_kernel = grads()
    used = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if used != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        raise AssertionError(f"Attention autograd: kernel launches {used}")
    saved = blocks_mod.flash_attention
    try:
        blocks_mod.flash_attention = flash_attention_plain
        g_plain = grads()
    finally:
        blocks_mod.flash_attention = saved
    failed = []
    result = grad_errors("autograd", "Attention [2, 64, 64, 512]", names, g_kernel, g_plain,
                         used, failed)
    if failed:
        raise AssertionError(f"Attention autograd: kernel path disagrees with the plain path: "
                             f"{failed}")
    return result


def serve_requests(request, x_all, wrappers, per_forward, steps, tag):
    """Phases 3 and 10: 4 bs1 requests of one slice (seeds 100-103) and 2
    batches of 4 (seeds 200-201) after a warm-up of each, with the launches
    of ``per_forward`` per UNet forward (the scan and flash kernels, and
    every kernel ``per_forward`` does not name, none).  Returns the record
    and the outputs."""
    request(x_all[:1], 0)  # warm-up, outside the counted run
    request(x_all, 0)
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t_bs1, t_bs4, outs = [], [], []
    for i in range(4):
        t0 = time.perf_counter()
        outs.append(request(x_all[i:i + 1], 100 + i))
        t_bs1.append(time.perf_counter() - t0)
    for i in range(2):
        t0 = time.perf_counter()
        outs.append(request(x_all, 200 + i))
        t_bs4.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    forwards = (4 + 2) * steps
    for k, n in launches.items():
        if n != per_forward.get(k, 0) * forwards:
            raise AssertionError(f"{tag}: {k} {n} launches in {forwards} UNet forwards, want "
                                 f"{per_forward.get(k, 0)} per forward")
    size = x_all.shape[1]
    for o in outs:
        if o.shape[1:] != (size, size, 1) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"bad output {tuple(o.shape)} finite={torch.isfinite(o).all()}")
        if float(o.min()) < 0.0 or float(o.max()) > 1.0:
            raise AssertionError("output leaves the [0, 1] window")
    sps1 = 1.0 / statistics.median(t_bs1)
    sps4 = 4.0 / statistics.median(t_bs4)
    log(f"[{tag}] launches {launches} over {forwards} UNet forwards "
        f"({per_forward} per forward)")
    return dict(launches=launches, forwards=forwards, bs1_slices_per_s=sps1,
                bs4_slices_per_s=sps4, bs1_request_s=t_bs1, bs4_batch_s=t_bs4,
                peak_memory_gib=peak_gib, steps=steps, size=size), outs


def gn_share(card, forward_busy_ms):
    """Phase 11: the 38 GroupNorm epilogues of one bs1 fp32 vanilla forward
    at their shapes (per (H, C): block1 with the scale/shift, block2 with the
    residual), run as ``group_norm_silu`` calls on each route under
    ``torch.profiler``: their device-busy time against that of one such
    forward (phase 8's profile)."""
    from founddiff_tpu_torch.ops.groupnorm import group_norm_silu

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(38)
    calls = []
    for (H, C), n in GN_BLOCKS.items():
        x, r = (_n(gen, (1, H, H, C), 1.0, dev) for _ in range(2))
        g, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
        ss = (_n(gen, (1, C), 0.2, dev), _n(gen, (1, C), 0.2, dev))
        calls += [lambda x=x, g=g, b=b, ss=ss: group_norm_silu(x, g, b, scale_shift=ss)] * n
        calls += [lambda x=x, g=g, b=b, r=r: group_norm_silu(x, g, b, residual=r)] * n
    result = {}
    for route, env in (("default", {}), ("kernels", {"FOUNDDIFF_GN": ROUTES["FOUNDDIFF_GN"]})):
        with routes_on(**env):
            for f in calls:  # warm-up
                f()
            prof = profile_device(lambda: [f() for f in calls], f"vanilla gn epilogues {route}",
                                  top=4)
        result[route] = dict(busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                             share_of_forward_busy=prof["busy_ms"] / forward_busy_ms)
    log(f"[vanilla gn] the 38 GroupNorm epilogues of one bs1 fp32 vanilla forward, device-busy: "
        f"default route {result['default']['busy_ms']:.3f} ms "
        f"({100 * result['default']['share_of_forward_busy']:.1f}% of the forward's "
        f"{forward_busy_ms:.2f} ms in phase 8), the two kernels "
        f"{result['kernels']['busy_ms']:.3f} ms "
        f"({100 * result['kernels']['share_of_forward_busy']:.1f}%) [{card}]")
    return dict(result, forward_busy_ms=forward_busy_ms)


def psnr(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    for k in ROUTES:  # phases 1-9 run the default routes; 10 and 11 set their own
        os.environ.pop(k, None)
    from founddiff_tpu_torch.ops import _build
    from founddiff_tpu_torch.ops import attn_block as attn_mod
    from founddiff_tpu_torch.ops import experimental_unified as unified_mod
    from founddiff_tpu_torch.ops import flash_attention as flash_mod
    from founddiff_tpu_torch.ops import groupnorm as gn_mod
    from founddiff_tpu_torch.ops import norm as norm_mod
    from founddiff_tpu_torch.ops import scan as scan_mod
    from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global SFU_EXP_PER_S
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    SFU_EXP_PER_S = SFU_PER_SM_CLOCK * sms * clock_mhz * 1e6
    log(f"[card] {sms} SMs, maximum SM clock {clock_mhz:.0f} MHz: SFU bound "
        f"{SFU_EXP_PER_S:.4e} exponentials/s ({SFU_PER_SM_CLOCK} per SM per clock)")

    # phase 1: build
    built = _build.build_all()
    log(f"[build] {built['seconds']:.1f} s for {', '.join(_build.SOURCES)}")
    for name, text in built["logs"].items():
        regs = [int(w) for line in text.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt.startswith("registers")]
        spills = sum(", 0 bytes spill stores" not in line
                     for line in text.splitlines() if "spill stores" in line)
        log(f"[ptxas {name}] {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} with spills")

    # gn_stats returns [B, 2, C]: held as its two halves, each against its own scale
    halves = lambda fn: lambda x: tuple(fn(x).unbind(1))
    ops = {
        "ss2d_image_block": (ss2d_mod.ss2d_image_block, ss2d_mod.ss2d_image_block_plain),
        "attn_block": (attn_mod.attn_block, attn_mod.attn_block_plain),
        "layer_norm_modulated": (norm_mod.layer_norm_modulated,
                                 norm_mod.layer_norm_modulated_plain),
        "scan_forward": (scan_mod.scan_forward, lambda *a: scan_mod.scan_forward_plain(
            *a, scan_mod.scan_chunk(a[2].shape[-1]))),
        "scan_backward": (scan_mod.scan_backward, lambda *a: scan_mod.scan_backward_plain(
            *a, scan_mod.scan_chunk(a[2].shape[-1]))),
        "scan_image_forward": (scan_mod.scan_image_forward,
                               scan_mod.scan_image_forward_plain),
        "flash_fwd": (flash_mod.flash_fwd, flash_mod.flash_fwd_plain),
        "flash_bwd_dq": (flash_mod.flash_bwd_dq, flash_mod.flash_bwd_dq_plain),
        "flash_bwd_dkv": (flash_mod.flash_bwd_dkv, flash_mod.flash_bwd_dkv_plain),
        "gn_stats": (halves(gn_mod.gn_stats), halves(gn_mod.gn_stats_plain)),
        "gn_apply": (gn_mod.gn_apply, gn_mod.gn_apply_plain),
        "ss2d_mamba_block": (unified_mod.ss2d_mamba_block, unified_mod.ss2d_mamba_block_plain),
    }
    wrappers = {k: getattr(mod, k) for k, mod in (
        ("ss2d_image_block", ss2d_mod), ("attn_block", attn_mod),
        ("layer_norm_modulated", norm_mod), ("scan_forward", scan_mod),
        ("scan_backward", scan_mod), ("scan_image_forward", scan_mod), ("flash_fwd", flash_mod),
        ("flash_bwd_dq", flash_mod), ("flash_bwd_dkv", flash_mod), ("gn_stats", gn_mod),
        ("gn_apply", gn_mod), ("ss2d_mamba_block", unified_mod))}

    # phase 2: kernels against their plain versions
    cases = [(b, *c) for b in (1, 4) for c in kernel_cases(b)]
    cases += [(TRAIN_BATCH, *c) for c in train_cases()]
    cases += flash_cases()
    cases += [(b, *c) for b in (1, TRAIN_BATCH, 4) for c in route_cases(b)]
    rows, failed = check_kernels(ops, cases)
    record = dict(card=card, build_seconds=built["seconds"], ptxas=built["logs"],
                  kernel_cases=rows)
    if failed:
        _write_record(record)
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    # phase 3: the main path at full width
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.models import ss2d as ss2d_model
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    cfg = Config()
    t0 = time.perf_counter()
    diffusion, model = build(cfg, device="cuda", seed=0)
    perturb_gates(model, seed=0)
    torch.cuda.synchronize()
    log(f"[main] build(Config()) on cuda: {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters")
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=torch.bfloat16)
    size = cfg.diffusion.image_size
    x_all = torch.from_numpy(np.random.default_rng(0).random((4, size, size, 1),
                                                             dtype=np.float32)).cuda()
    steps = cfg.diffusion.sampling_timesteps

    def request(x, seed):
        out = sampler(x, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return out

    record["main"], outs = serve_requests(request, x_all, wrappers, PER_FORWARD, steps, "main")
    main = record["main"]
    log(f"[main] DDIM-{steps} {size}^2 bf16: bs1 {main['bs1_slices_per_s']:.3f} slices/s "
        f"(request s {[round(t, 4) for t in main['bs1_request_s']]}), bs4 "
        f"{main['bs4_slices_per_s']:.3f} slices/s (batch s "
        f"{[round(t, 4) for t in main['bs4_batch_s']]}), peak memory "
        f"{main['peak_memory_gib']:.2f} GiB [{card}]")

    # phase 4: numerics gate, kernel path against the plain path
    x1 = x_all[:1]
    fused = request(x1, 7)
    plain_default = {"ss2d_image_block": ss2d_mod.ss2d_image_block_plain,
                     "attn_block": attn_mod.attn_block_plain,
                     "layer_norm_modulated": norm_mod.layer_norm_modulated_plain}
    saved = {n: getattr(ss2d_model, n) for n in plain_default}
    try:
        for n, fn in plain_default.items():
            setattr(ss2d_model, n, fn)
        t0 = time.perf_counter()
        plain = request(x1, 7)
        t_plain = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(ss2d_model, n, fn)
    gate_db = psnr(fused, plain)
    max_diff = float((fused - plain).abs().max())
    log(f"[gate] DDIM-{steps} {size}^2 bs1 bf16 kernel vs plain path: PSNR {gate_db:.2f} dB "
        f"(gate {PSNR_GATE_DB}), max |diff| {max_diff:.3e}, plain path {t_plain:.2f} s")
    record["gate"] = dict(psnr_db=gate_db, threshold_db=PSNR_GATE_DB, max_abs_diff=max_diff)
    if not (math.isfinite(max_diff) and gate_db >= PSNR_GATE_DB):
        raise AssertionError(f"numerics gate failed: {gate_db:.2f} dB")

    # phase 5: where the device time of one request goes
    record["profile"] = {f"bs{len(x)}": profile_device(lambda: request(x, 9), f"bs{len(x)}")
                         for x in (x_all[:1], x_all)}

    # phase 6: autograd through the kernels against the plain path
    record["autograd"] = check_autograd(ss2d_model, plain_default, wrappers)
    # phase 7: training at full width
    record["train"] = train_full_width(wrappers, card, Config(), PER_STEP, "train")
    # phase 8: the vanilla DDPM path, serving
    record["vanilla"], vanilla_sample = vanilla_serving(wrappers, card, {"flash_fwd": 250})
    # phase 9: the vanilla DDPM path, training, and autograd through its Attention
    record["vanilla_train"] = train_full_width(wrappers, card, vanilla_config(),
                                               VANILLA_PER_STEP, "vanilla train")
    record["attention_autograd"] = check_attention_autograd(wrappers)

    # phase 10: FoundDiff with both opt-in routes on
    with routes_on(**ROUTES):
        record["routes"], outs_on = serve_requests(request, x_all, wrappers, PER_FORWARD_ROUTES,
                                                   steps, "routes")
        on = record["routes"]
        on["psnr_db"] = psnr(outs_on[0], outs[0])
        on["max_abs_diff"] = float((outs_on[0] - outs[0]).abs().max())
        log(f"[routes] DDIM-{steps} {size}^2 bf16, {ROUTES}: bs1 "
            f"{on['bs1_slices_per_s']:.3f} slices/s (request s "
            f"{[round(t, 4) for t in on['bs1_request_s']]}), bs4 {on['bs4_slices_per_s']:.3f} "
            f"slices/s (batch s {[round(t, 4) for t in on['bs4_batch_s']]}), peak memory "
            f"{on['peak_memory_gib']:.2f} GiB; default routes (phase 3): bs1 "
            f"{main['bs1_slices_per_s']:.3f}, bs4 {main['bs4_slices_per_s']:.3f} slices/s, "
            f"{main['peak_memory_gib']:.2f} GiB [{card}]")
        log(f"[routes gate] the bs1 request of seed 100 against phase 3's: PSNR "
            f"{on['psnr_db']:.2f} dB (gate {PSNR_GATE_DB}), max |diff| {on['max_abs_diff']:.3e}")
        if not (math.isfinite(on["max_abs_diff"]) and on["psnr_db"] >= PSNR_GATE_DB):
            raise AssertionError(f"routes numerics gate failed: {on['psnr_db']:.2f} dB")
        on["profile"] = profile_device(lambda: request(x_all[:1], 9), "routes bs1")
        record["routes_autograd"] = check_autograd(
            ss2d_model, dict(plain_default,
                             ss2d_mamba_block=unified_mod.ss2d_mamba_block_plain),
            wrappers, "autograd routes")
    record["gn_autograd"] = check_gn_autograd(wrappers)
    with routes_on(**ROUTES):
        record["routes_train"] = train_full_width(wrappers, card, Config(), PER_STEP_ROUTES,
                                                  "train routes", full=False)
    log(f"[train routes] fp32 step {statistics.median(record['routes_train']['step_s']):.4f} s "
        f"with {ROUTES}, {statistics.median(record['train']['step_s']):.4f} s on the default "
        f"routes (phase 7) [{card}]")

    # phase 11: the vanilla path with the GroupNorm route on
    with routes_on(FOUNDDIFF_GN=ROUTES["FOUNDDIFF_GN"]):
        record["vanilla_gn"], _ = vanilla_serving(
            wrappers, card, {"flash_fwd": 250, "gn_stats": 250 * 38, "gn_apply": 250 * 38},
            "vanilla gn", reference=vanilla_sample)
        record["vanilla_gn_train"] = train_full_width(wrappers, card, vanilla_config(),
                                                      VANILLA_PER_STEP_GN, "vanilla train gn",
                                                      full=False)
    v, vg = record["vanilla"], record["vanilla_gn"]
    log(f"[vanilla gn] FOUNDDIFF_GN={ROUTES['FOUNDDIFF_GN']} against the default route "
        f"(phases 8, 9): DDIM-250 {vg['sample_s']:.3f} / {v['sample_s']:.3f} s, forwards/s "
        f"bs1 {vg['forwards_per_s_bs1']:.3f} / {v['forwards_per_s_bs1']:.3f}, bs4 "
        f"{vg['forwards_per_s_bs4']:.3f} / {v['forwards_per_s_bs4']:.3f}, fp32 step "
        f"{statistics.median(record['vanilla_gn_train']['step_s']):.4f} / "
        f"{statistics.median(record['vanilla_train']['step_s']):.4f} s [{card}]")
    record["gn_share"] = gn_share(card, v["profile"]["busy_ms"])

    kernels = []
    for k, (src, tpu) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == k]
        if k in SERVING:  # one bs1 bf16 UNet forward
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = main["launches"][k]
        elif k == "ss2d_mamba_block":  # one bs1 bf16 UNet forward, both routes on
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = record["routes"]["launches"][k]
        elif k in ("flash_fwd",) + GN:  # one bs1 fp32 vanilla UNet forward
            main_rows = [r for r in mine if r["dtype"] == "float32" and r["batch"] == 1]
            n = record["vanilla_gn" if k in GN else "vanilla"]["launches"][k]
        else:  # one fp32 train step
            main_rows = [r for r in mine if r["dtype"] == "float32"]
            n = record["vanilla_train" if k in FLASH_BWD else "train"]["launches"][k]
        total = lambda key: sum(r[key] * r["per_forward"] for r in main_rows)
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=tpu, launches=n,
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms") if main_rows[0]["library_ms"] is not None else None))
    record["kernels"] = kernels
    _write_record(record)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _write_record(record) -> None:
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
