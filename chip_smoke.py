#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit,
   turns TF32 off (for every fp32 comparison, and for the fp32 serving and
   training of phases 7-14), builds the nine kernel libraries from
   ``founddiff_tpu_torch/csrc`` (one nvcc per source, all started together)
   and prints the build seconds, each library's most registers and
   spilling kernels, and the registers and spills of each runtime-N scan
   kernel.  Phases 1-9 run with ``FOUNDDIFF_GN`` and
   ``FOUNDDIFF_UNIFIED`` unset (the default routes); 10 and 11 set them.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every distinct shape its path gives it: the serving kernels
   at bs1 and bs4, the scan kernels at the training batch (2 slices per
   microbatch, so 8 direction sequences), the flash kernels at the vanilla
   UNet's bottleneck ([1, 4, 4096, 32] serving, [2, 4, 4096, 32] training)
   and at a ragged Lq 1000 / Lk 777, the GroupNorm pair at the seven (H, C)
   of both UNets at batches 1, 2 and 4 as block1 calls it (the time
   scale/shift as the ``.chunk`` views of one [B, 2C] tensor) and as block2
   calls it (the residual), and at groups 4 and the 360^2 and 45^2
   ResnetBlocks of a 360^2 slice, the unified op at the
   MambaBlock shapes at batches 1, 2 and 4, in fp32 and bf16, with the stated
   tolerance (the scan backward's seven gradients each); prints the errors,
   the kernel's and the plain version's times (CUDA events, warmed up,
   median of 7), the bound (the largest of bytes / 3.35 TB/s, operations /
   the peak rate of their unit, fp32 products as three TF32 products on the
   tensor cores, and for the flash kernels the exponentials /
   the SFU rate, 16 per SM per clock at the card's maximum SM clock) and,
   for the flash kernels, the time of ``scaled_dot_product_attention`` (its
   forward; its backward through autograd for the two backward kernels),
   for the GroupNorm pair that of ``F.group_norm`` on a contiguous NCHW
   copy, in ``gn_apply``'s rows only (the pair's one yardstick: the
   normalisation and a per-channel affine, without the per-image fold, the
   silu or the residual), for ``layer_norm`` that of ``F.layer_norm``.  The
   kernels of phases 12-14: ``scan_fused_forward`` at the three 45^2
   MambaBlocks of a 360^2 slice (L 529, D 512 and 1024, N 32) at batches 1,
   2 and 4, its h_bounds also against ``scan_forward``'s on the same
   delta/B/C and its y without h_bounds (the serving call) bit for bit
   against its y with them; ``layer_norm`` at those rows (B * 2025, C 512
   and 1024) with and without its affine; the epilogue ``merge_ln_gate``
   on the joint layout at the 360^2 top scale where the JAX package runs it
   on a TPU ([B, 4, 32400, 128], Co 64) and on the split layout at the
   16^2 route's 2x2 grids (C 512 and 1024) and at 360^2 and 180^2, with and
   without the folded out_proj, and at a 2x2 grid with C 2048 (in fp32 the
   two-launch form: og and the weight slice exceed a block's shared
   memory).  The edges of the redesigned kernels, none on the main path:
   ``ss2d_image_block`` in bf16 on the tensor cores at C0 40, N 4
   (ragged GEMM tiles), ``layer_norm`` and ``layer_norm_modulated`` at C 100
   and on a misaligned view; and every scan kernel, the fused block and the
   unified op at d_state 64, at the 32^2 blocks of phase 15.  At d_state 12
   and 128 (sizes no kernel template holds: the runtime-N scans take them
   as they are, the register-resident kernels padded to 16 or in two groups
   of 64): ``scan_forward`` (also bounds-only, its h_bounds against the
   plain version's) and ``scan_backward`` at a ragged L (L 529, D 256) at
   the training batch, and ``scan_image_forward``, ``scan_fused_forward``,
   ``ss2d_image_block`` and ``ss2d_mamba_block`` at the 32^2 blocks of
   phase 15 (C0 512).  Then ``scan_forward``'s bounds-only h_bounds against
   its full mode's, bit for bit, at every scan_forward shape of phase 2.
   ``attn_block`` also at the three C = 64 MambaBlocks of a 512^2 slice
   (512^2 and 256^2 at bs4), where ``FOUNDDIFF_ATTN_BLOCK=on`` takes it and
   the default runs the plain composition, timed beside that composition;
   the device time of each launch of the GroupNorm pair, redesigned last
   (``torch.profiler``), over the 38 epilogues of a bs1 fp32 vanilla UNet
   forward on the kernel route, and the launches of one epilogue; the
   summed times and bounds of ``scan_fused_forward`` and ``merge_ln_gate``
   per bs4 forward and (``scan_fused_forward``) per fp32 step, and of the
   two flash backward kernels per bf16 step beside SDPA's backward; and the
   key (``flash_bwd_dq``) or query (``flash_bwd_dkv``) parts each phase-2
   backward launch splits the other side into (``[parts]`` lines).
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
   10 of them bounds-only, 18 ``scan_backward``); prints the step time beside
   the parent tree's, slices/s, peak memory and one profiled step.

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
   timed on each route against that forward's device-busy time, with each
   route's launches per epilogue.
12. FoundDiff serving on slices whose deepest grid is odd: the phase-3
   model on 4 bs1 requests of a 360^2 slice (8 x 45: the three deepest
   MambaBlocks run at 45^2, on the unfused route) and 2 batches of 4, with 6
   ``ss2d_image_block``, 18 ``layer_norm_modulated``, 3
   ``scan_fused_forward`` and 3 ``layer_norm`` launches per UNet forward
   and no other; slices/s, peak memory, PSNR >= 40 dB of the bs1 request
   against the plain path (every kernel swapped for its plain version) and
   a profile of one bs1 and one bs4 request; then the same requests of 16^2
   slices (the three deepest grids 2x2, on the epilogue route: 6
   ``ss2d_image_block``, 1 ``attn_block``, 17 ``layer_norm_modulated``, 3
   ``scan_image_forward`` and 3 ``merge_ln_gate`` per forward), PSNR >= 40
   dB of the bs1 request against the plain path.
13. Autograd as phase 6 on the two new routes: one MambaBlock on the
   unfused route (45^2, C 256, N 32) and one on the epilogue route (2x2, C
   512, N 32), batch 2, fp32, kernel path against the plain path.
14. Training at 360^2: phase 7 on ``Config()`` with ``image_size`` 360
   (1 warm-up, 3 timed fp32 steps, a profiled step and 2 bf16 steps), with
   12 / 36 / 6 / 6 / 12 / 18 launches per step of ``ss2d_image_block``,
   ``layer_norm_modulated``, ``scan_fused_forward``, ``layer_norm``,
   ``scan_forward`` and ``scan_backward`` and no other; the step time
   beside the parent tree's.
15. d_state 64: ``Config()`` with ``dim_mults`` (1, 2, 4, 8, 16) (down_4, mid
   and up_0 on a 32^2 grid with d_state 64), one bs1 bf16 request of a
   512^2 slice with 11 ``ss2d_image_block``, 8 ``attn_block`` and 14
   ``layer_norm_modulated`` launches per UNet forward, PSNR >= 40 dB against
   the plain path, and autograd as phase 6 on one MambaBlock at 32^2, C 512,
   d_state 64.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches on
its path, phase 3 for the serving kernels, phase 12's 360^2 requests for
``scan_fused_forward`` and ``layer_norm`` and its 16^2 requests for
``merge_ln_gate``, phase 10's requests for
``ss2d_mamba_block``, phase 7's timed steps for the scan kernels, phase 8's
sample for ``flash_fwd``, phase 11's for the GroupNorm pair and phase 9's
timed fp32 steps for the flash backward; the worst error of phase 2; and the
summed times of the calls of one bs1 bf16 UNet forward (serving kernels and
``ss2d_mamba_block`` at 512^2, ``scan_fused_forward`` and ``layer_norm`` at
360^2, ``merge_ln_gate`` at 16^2), one bs1 fp32 vanilla UNet forward (``flash_fwd``, the
GroupNorm pair) or one fp32 train step (the scan and flash backward
kernels); ``d_state``, the state sizes phase 2 held it at, where it has
one; and for ``scan_fused_forward``, ``merge_ln_gate`` and the two flash
backward kernels ``units``, their time and bound summed over a bs4 bf16
forward, for the scan also over an fp32 360^2 train step, for the flash
backward over a bf16 train step with SDPA's backward beside them); the
last is ``{"ok": true, "device": {...}}``.
A longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): device memory rate and peak rates.
# A product's operations count at the peak of the unit that can take them:
# bf16 on the tensor cores; fp32 as three TF32 products on the tensor cores
# (the split the port's fp32 kernels use, about fp32's accuracy), so at a
# third of the TF32 rate.  fp32 work that is not a product (scans, norms,
# softmax arithmetic) counts at the CUDA cores' rate.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 494.7e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: TF32_FLOPS / 3}
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
    "scan_fused_forward": ("founddiff_tpu_torch/csrc/scan.cu",
                           "founddiff_tpu/ops/scan_pallas.py:630"),
    "layer_norm": ("founddiff_tpu_torch/csrc/ln_mod.cu", "founddiff_tpu/ops/norm_pallas.py:23"),
    "merge_ln_gate": ("founddiff_tpu_torch/csrc/ss2d_epilogue.cu",
                      "founddiff_tpu/ops/ss2d_fused.py:32"),
}
SERVING = ("ss2d_image_block", "attn_block", "layer_norm_modulated")
# csrc/scan.cu's kernels that take d_state at run time (their mangled names)
RUNTIME_N_KERNELS = ("fwd_kernel", "bwd_local_kernel", "bwd_main_kernel", "carry_scan_kernel",
                     "reduce_params_kernel")
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
# the two routes of phases 12-14: a 360^2 slice (8 x 45) puts down_3, mid and
# up_0 on a 45^2 grid (odd: the unfused route), a 16^2 slice on a 2x2 grid
# (even but too small for the fused block: the epilogue route, whose image
# scan takes those grids); (C, d_state, blocks per UNet forward) of the three
ODD_SIZE, EPI_SIZE = 360, 16
DEEP = ((256, 32, 1), (512, 32, 2))
ODD_L = 23 ** 2  # the scan length of a 45^2 grid: efficient_scan pads it to 46^2
# launches per UNet forward at 360^2 (the six even blocks on the fused
# block, no attn_block: C < 128 or H % 8 != 0 at every scale) and at 16^2
# (the attention half of up_2, 8^2 at C 128, on attn_block)
PER_FORWARD_360 = {"ss2d_image_block": 6, "layer_norm_modulated": 18,
                   "scan_fused_forward": 3, "layer_norm": 3}
PER_FORWARD_16 = {"ss2d_image_block": 6, "attn_block": 1, "layer_norm_modulated": 17,
                  "scan_image_forward": 3, "merge_ln_gate": 3}
# launches per train step at 360^2: the forward twice, the remat backward of
# the six fused blocks on the decimated scan (image_scan_vmem_ok is False at
# every even 360^2 scale), the three unfused blocks' scan backward
PER_STEP_360 = {"ss2d_image_block": 12, "layer_norm_modulated": 36, "scan_fused_forward": 6,
                "layer_norm": 6, "scan_forward": 12, "scan_backward": 18}
# phase 15: a five-level UNet (dim 64 x (1, 2, 4, 8, 16)) at 512^2 puts
# down_4 (C 512), mid and up_0 (C 1024) on a 32^2 grid with d_state 64;
# per UNet forward 11 fused blocks, 8 attention halves (C >= 128 at H % 8 ==
# 0) and 14 layer_norm_modulated (11 norm1, 3 norm2 at C 64)
FIVE_MULTS = (1, 2, 4, 8, 16)
PER_FORWARD_5 = {"ss2d_image_block": 11, "attn_block": 8, "layer_norm_modulated": 14}
N64 = ((512, 64), (1024, 64))  # (C0, d_state) of the 32^2 blocks
# d_state sizes no kernel template holds (padded to 16; two groups of 64)
ODD_STATES = (12, 128)
# the fp32 train step of the parent tree, seconds, at 512^2 and 360^2:
# scripts/port_ab.py, the parent's two turns of one call, NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md section 6)
PARENT_STEP_S = {512: (0.8548, 0.8435), 360: (1.1291, 1.4072)}


def runtime_n_ptxas(text):
    """(kernel, registers, spill-store bytes) of csrc/scan.cu's runtime-N
    kernels from nvcc's -Xptxas -v log; the kernel named with its template
    arguments as mangled (If: float, I13__nv_bfloat16: bf16, Li8E: 8, Lb1E:
    true)."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in RUNTIME_N_KERNELS if k in mangled), None)
            if name and mangled.split(name, 1)[1].startswith("I"):  # a template
                args = mangled.split(name, 1)[1].split("EEv")[0]
                args = args.replace("I13__nv_bfloat16", "bf16,").replace("If", "float,")
                name += "<" + re.sub(r"L[ib](\d+)E", r"\1,", args).strip("I,") + ">"
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line:
            out.append((name, int(line.split("Used")[1].split()[0]), spill))
            name = None
    return out


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
    in bf16, TF32_FLOPS / 3: fp32 products on the tensor cores, 67e12: fp32
    CUDA cores, ``SFU_EXP_PER_S``: exponentials).  Work
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
    # in, temperature, proj_w, the modulation and the gate in fp32
    moved = 2 * io * P * C + io * (3 * C * C + 27 * C) + 4 * (heads + C * C + 3 * B * C)
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


def scan_fwd_case(H, C, N, dtype, gen, dev, bounds_only=False):
    from founddiff_tpu_torch.ops.scan import scan_chunk

    args = _scan_operands(H, C, N, dtype, gen, dev)
    u, _, _, Bm = args[:4]
    G, L, D = TRAIN_BATCH * 4, u.shape[2], u.shape[3]
    hb_bytes = 4 * G * -(-L // scan_chunk(N)) * N * D
    if bounds_only:
        # u, delta, B, A and bias in, h_bounds out; the recurrence alone,
        # about 3N + 5 operations per step per channel
        moved = nbytes(*args[:4], args[6]) + hb_bytes
        return args, {}, None, moved, [(G * L * D * (3 * N + 5), FP32_FLOPS)]
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


def scan_fused_case(B, C0, N, dtype, gen, dev, L=ODD_L):
    """The fused-projection scan of one 45^2 block (by default) at batch B:
    xs the padded decimated sequences of a post-silu activation, the folded
    weights at the io dtype."""
    from founddiff_tpu_torch.ops.scan import _derive_weights, scan_chunk

    D, R = 2 * C0, -(-C0 // 16)
    xs = torch.nn.functional.silu(_n(gen, (B, 4, L, D), 1.0, dev)).to(dtype)
    w = _derive_weights(_u(gen, (4, R + 2 * N, D), D ** -0.5, dev),
                        _u(gen, (4, D, R), R ** -0.5, dev), R, N)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous().to(dev)
    args = (xs, *(t.contiguous().to(dtype) for t in w), A, torch.ones(4, D, device=dev),
            _dt_bias(gen, 4, D, dev))
    G = 4 * B
    # xs and the folded weights in and y out at the io dtype, A, Dskip and
    # bias in and h_bounds out in fp32; the folded projection (D + 2N
    # multiply-adds per step and channel) on the io dtype's unit, the scan
    # in fp32
    moved = nbytes(*args) + nbytes(xs) + 4 * G * -(-L // scan_chunk(N)) * N * D
    mm = 2 * G * L * D * (D + 2 * N)
    return args, {}, None, moved, [(mm, PEAK_FLOPS[dtype]), (G * L * D * (6 * N + 5), FP32_FLOPS)]


def layer_norm_case(B, C, affine, dtype, gen, dev):
    """out_norm of a 45^2 block: B * 2025 rows of C; ``F.layer_norm`` (its
    affine at the io dtype) is the yardstick."""
    x = _n(gen, (B, 45 * 45, C), 1.0, dev).add_(0.3).to(dtype)
    g = _n(gen, (C,), 0.1, dev).add_(1.0) if affine else None
    b = _n(gen, (C,), 0.1, dev) if affine else None
    lib_w = [None if t is None else t.to(dtype) for t in (g, b)]
    library = lambda: torch.nn.functional.layer_norm(x, (C,), *lib_w, 1e-5)
    # x in and out at the io dtype, the affine in fp32; about 8 operations per element
    return ((x, g, b), {}, None, nbytes(x, g, b) + nbytes(x), [(8 * x.numel(), FP32_FLOPS)],
            library)


def epilogue_case(B, H, C, Co, split, fold, dtype, gen, dev):
    """The SS2D epilogue at batch B on an H x H grid: ys joint [B, 4, L, C]
    or split (its row and column views), raw z, the out_norm affine, local
    at the io dtype and, with ``fold``, out_proj [C, Co], the adaLN gate
    and the residual."""
    L, P = (H // 2) ** 2, B * H * H
    io = torch.tensor([], dtype=dtype).element_size()
    ys = _n(gen, (B, 4, L, C), 1.0, dev).to(dtype)
    z = _n(gen, (B, H, H, C), 1.0, dev).to(dtype)
    scale, bias = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
    local = _n(gen, (B, C), 0.2, dev).to(dtype)
    kw = dict(H=H, W=H, gate_silu=True, split=split)
    args = (ys[:, 0::2], ys[:, 1::2]) if split else (ys,)
    args += (z, scale, bias, local)
    # ys, z and local in at the io dtype, the affine in fp32; out at the io
    # dtype (C channels, or with fold Co after the residual, out_proj at the
    # io dtype and the gate in fp32 are read); per element about 14 fp32
    # operations and one exponential (silu), with fold out_proj's products
    moved = nbytes(ys, z, scale, bias, local)
    work = [(14 * P * C, FP32_FLOPS), (P * C, SFU_EXP_PER_S)]
    if fold:
        kw.update(proj_w=_u(gen, (C, Co), C ** -0.5, dev), gate=_n(gen, (B, Co), 0.3, dev),
                  residual_x=_n(gen, (B, H, H, Co), 1.0, dev).to(dtype))
        moved += 2 * io * P * Co + io * C * Co + 4 * B * Co
        work.append((2 * P * C * Co, PEAK_FLOPS[dtype]))
    else:
        moved += io * P * C
    return args, kw, kw.get("residual_x"), moved, work


def unfused_cases(B):
    """(kernel, label, calls per bs1 UNet forward, builder) of the kernels of
    phases 12-14 at batch B: the fused scan and ``layer_norm`` at the 360^2
    slice's three 45^2 blocks (``layer_norm`` also without its affine, 0
    calls), the epilogue at the 16^2 slice's three 2x2 blocks (split) and,
    0 calls, at the JAX package's 360^2 top-scale shapes (joint), at
    360^2 and 180^2 split, with and without the folded out_proj, and at C
    2048 on a 2x2 grid (fp32: the two-launch form)."""
    cases = []
    serve = B != TRAIN_BATCH  # the epilogue runs when serving only
    for C0, N, n in DEEP:
        D = 2 * C0
        cases.append(("scan_fused_forward", f"bs{B} 45^2 L={ODD_L} D={D} N={N}", n,
                      lambda dt, g, d, C0=C0, N=N: scan_fused_case(B, C0, N, dt, g, d)))
        for affine in (True, False):
            cases.append(("layer_norm", f"bs{B} R={B * 2025} C={D}"
                          + ("" if affine else " no affine"), n if affine else 0,
                          lambda dt, g, d, D=D, a=affine: layer_norm_case(B, D, a, dt, g, d)))
        if serve:
            cases.append(("merge_ln_gate", f"bs{B} split 2x2 C={D} Co={C0}", n,
                          lambda dt, g, d, D=D, C0=C0: epilogue_case(B, 2, D, C0, True, True,
                                                                     dt, g, d)))
    if serve:
        cases.append(("merge_ln_gate", f"bs{B} joint 360^2 C=128 Co=64", 0,
                      lambda dt, g, d: epilogue_case(B, 360, 128, 64, False, True, dt, g, d)))
    if B == 1:
        for label, H, C, Co, split, fold in (
                ("joint 360^2 C=128 no fold", 360, 128, 128, False, False),
                ("split 360^2 C=128 Co=64", 360, 128, 64, True, True),
                ("split 180^2 C=256 Co=128", 180, 256, 128, True, True),
                ("split 2x2 C=1024 no fold", 2, 1024, 1024, True, False),
                ("split 2x2 C=2048 Co=1024", 2, 2048, 1024, True, True)):
            cases.append(("merge_ln_gate", f"bs1 {label}", 0,
                          lambda dt, g, d, a=(H, C, Co, split, fold): epilogue_case(
                              1, *a, dt, g, d)))
    return cases


def ln_ragged_case(kname, R, C, aligned, dtype, gen, dev):
    """``layer_norm`` / ``layer_norm_modulated`` on x [1, R, C] where C need
    not be a multiple of 8 and x may be a contiguous view that starts one
    element into its storage (the row kernel's scalar loop); the modulation
    as the adaLN gives it, two chunks of one [1, 6C] row."""
    n = R * C
    buf = _n(gen, (n + 1,), 1.0, dev).add_(0.3).to(dtype)
    x = (buf[:n] if aligned else buf[1:]).view(1, R, C)
    g, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
    flops = 10 * x.numel()
    if kname == "layer_norm":
        lib_w = [t.to(dtype) for t in (g, b)]
        library = lambda: torch.nn.functional.layer_norm(x, (C,), *lib_w, 1e-5)
        return ((x, g, b), {}, None, nbytes(x, g, b) + nbytes(x), [(flops, FP32_FLOPS)],
                library)
    ms, mt = _n(gen, (1, 6 * C), 0.2, dev).chunk(6, dim=-1)[:2]
    return ((x, g, b, ms, mt), {}, None, nbytes(x, g, b, ms, mt) + nbytes(x),
            [(flops, FP32_FLOPS)])


def slice6_cases():
    """(batch, kernel, label, count, make) of the redesigned kernels'
    edges, none on the main path (count 0): the fused block in bf16 on the
    tensor cores at widths that leave ragged GEMM tiles (C0 40, N 4: D 80,
    D + 2N 88, L 36), the row LayerNorm at C 100 (no multiple of 8) and on
    a misaligned view; and every scan kernel, the fused block and the
    unified op at d_state 64, at the 32^2 blocks of phase 15's five-level
    UNet (the scans of its backward at the training batch)."""
    cases = [(1, "ss2d_image_block", "bs1 12^2 C0=40 D=80 N=4 ragged tiles", 0,
              lambda dt, g, d: ss2d_case(1, 12, 40, 4, dt, g, d))]
    for kname in ("layer_norm", "layer_norm_modulated"):
        for R, C, aligned in ((2025, 100, True), (2025, 512, False)):
            label = f"bs1 R={R} C={C}" + ("" if aligned else " misaligned")
            cases.append((1, kname, label, 0, lambda dt, g, d, k=kname, R=R, C=C, a=aligned:
                          ln_ragged_case(k, R, C, a, dt, g, d)))
    for C0, N in N64:
        cases.append((1, "ss2d_image_block", f"bs1 32^2 C0={C0} D={2 * C0} N={N}", 0,
                      lambda dt, g, d, C0=C0, N=N: ss2d_case(1, 32, C0, N, dt, g, d)))
    C0, N = N64[0]
    L = 16 * 16
    label = f"B{TRAIN_BATCH}x4 L={L} D={2 * C0} N={N}"
    cases += [
        (TRAIN_BATCH, "scan_forward", label, 0,
         lambda dt, g, d: scan_fwd_case(32, C0, N, dt, g, d)),
        (TRAIN_BATCH, "scan_backward", label, 0,
         lambda dt, g, d: scan_bwd_case(32, C0, N, dt, g, d)),
        (TRAIN_BATCH, "scan_image_forward", f"B{TRAIN_BATCH} 32^2 D={2 * C0} N={N}", 0,
         lambda dt, g, d: scan_image_case(32, C0, N, dt, g, d)),
        (1, "scan_fused_forward", f"bs1 L={L} D={2 * C0} N={N}", 0,
         lambda dt, g, d: scan_fused_case(1, C0, N, dt, g, d, L=L)),
        (1, "ss2d_mamba_block", f"bs1 32^2 C0={C0} D={2 * C0} N={N}", 0,
         lambda dt, g, d: mamba_case(1, 32, C0, N, dt, g, d)),
    ]
    return cases


def slice7_cases():
    """(batch, kernel, label, count, make) at the d_state sizes of
    ODD_STATES, none on the main path (count 0): the runtime-N scans at a
    ragged L (a 46^2 grid: L 529, D 256) at the training batch, scan_forward
    in both modes; the register-resident kernels (padded or grouped) at the
    32^2 blocks of phase 15's five-level UNet (C0 512)."""
    H, C, C0 = 46, 128, N64[0][0]
    L = (H // 2) ** 2
    cases = []
    for N in ODD_STATES:
        label = f"B{TRAIN_BATCH}x4 L={L} D={2 * C} N={N}"
        cases += [
            (TRAIN_BATCH, "scan_forward", label, 0,
             lambda dt, g, d, N=N: scan_fwd_case(H, C, N, dt, g, d)),
            (TRAIN_BATCH, "scan_forward bounds-only", label, 0,
             lambda dt, g, d, N=N: scan_fwd_case(H, C, N, dt, g, d, bounds_only=True)),
            (TRAIN_BATCH, "scan_backward", label, 0,
             lambda dt, g, d, N=N: scan_bwd_case(H, C, N, dt, g, d)),
            (TRAIN_BATCH, "scan_image_forward", f"B{TRAIN_BATCH} 32^2 D={2 * C0} N={N}", 0,
             lambda dt, g, d, N=N: scan_image_case(32, C0, N, dt, g, d)),
            (1, "scan_fused_forward", f"bs1 L=256 D={2 * C0} N={N}", 0,
             lambda dt, g, d, N=N: scan_fused_case(1, C0, N, dt, g, d, L=256)),
            (1, "ss2d_image_block", f"bs1 32^2 C0={C0} D={2 * C0} N={N}", 0,
             lambda dt, g, d, N=N: ss2d_case(1, 32, C0, N, dt, g, d)),
            (1, "ss2d_mamba_block", f"bs1 32^2 C0={C0} D={2 * C0} N={N}", 0,
             lambda dt, g, d, N=N: mamba_case(1, 32, C0, N, dt, g, d)),
        ]
    return cases


def check_bounds_only(cases):
    """``scan_forward``'s bounds-only h_bounds against its full mode's, bit
    for bit, at every scan_forward case of phase 2, fp32 and bf16."""
    from founddiff_tpu_torch.ops.scan import scan_forward

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(46)
    result, failed = {}, []
    for batch, kname, label, count, make in cases:
        if kname != "scan_forward":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            args = make(dtype, gen, dev)[0]
            y, hb = scan_forward(*args)
            none, hb_only = scan_forward(*args, bounds_only=True)
            same = none is None and y is not None and torch.equal(hb, hb_only)
            key = f"{label} {str(dtype).replace('torch.', '')}"
            result[key] = same
            if not same:
                failed.append(f"scan_forward bounds-only {key}")
            del args, y, hb, hb_only
    log(f"[kernel] scan_forward bounds-only h_bounds bit-identical to the full mode's: "
        f"{sum(result.values())} of {len(result)}")
    return result, failed


def check_fused_h_bounds():
    """``scan_fused_forward``'s h_bounds against ``scan_forward``'s on the
    same delta/B/C (their fp32 products; the fused kernel sums them in
    another order), fp32, at the training batch: the state the backward
    reads.  And its y without h_bounds (``bounds=False``, what serving
    calls) bit for bit against its y with them, fp32 and bf16."""
    from founddiff_tpu_torch.ops.scan import scan_forward, scan_fused_forward

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(45)
    result, failed = {}, []
    for C0, N, _ in DEEP:
        xs, wd, wb, wc, A, Ds, bias = scan_fused_case(TRAIN_BATCH, C0, N, torch.float32, gen,
                                                      dev)[0]
        _, hb = scan_fused_forward(xs, wd, wb, wc, A, Ds, bias)
        _, hb_ref = scan_forward(xs, xs @ wd[None], A, xs @ wb[None], xs @ wc[None], Ds, bias)
        err, excess, scale, tol, ok = compare(hb, hb_ref, None, torch.float32)
        label = f"B{TRAIN_BATCH} D={2 * C0} N={N}"
        log(f"[kernel] scan_fused_forward h_bounds against scan_forward's, {label}: err "
            f"{err:.3e}, past 1 ulp {excess:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        result[label] = dict(max_abs_err=err, err_past_ulp=excess, tol=tol, ok=ok)
        if not ok:
            failed.append(label)
        for dtype in (torch.float32, torch.bfloat16):
            args = (*(t.to(dtype) for t in (xs, wd, wb, wc)), A, Ds, bias)
            y, _ = scan_fused_forward(*args)
            y_only, none = scan_fused_forward(*args, bounds=False)
            same = none is None and torch.equal(y, y_only)
            key = f"{label} {str(dtype).replace('torch.', '')} y without h_bounds"
            log(f"[kernel] scan_fused_forward y without h_bounds bit-identical, {key}: {same}")
            result[key] = dict(ok=same)
            if not same:
                failed.append(key)
    return result, failed


# the three C = 64 MambaBlocks of a 512^2 slice (down_0, down_1, up_3): (H,
# blocks per UNet forward), where FOUNDDIFF_ATTN_BLOCK=on takes the fused
# attention half (the default keeps the plain composition there)
ATTN_ON_C64 = ((512, 2), (256, 1))


def attn_on_cases():
    """(batch, kernel, label, count, make) of ``attn_block`` at the C = 64
    shapes of ATTN_ON_C64 at bs4, none on the default path (count 0): the
    kernel timed beside the plain composition the default runs there."""
    return [(4, "attn_block", f"bs4 {H}^2 C=64 heads=2 (ATTN_BLOCK=on)", 0,
             lambda dt, g, d, H=H: attn_case(4, H, 64, dt, g, d)) for H, _ in ATTN_ON_C64]


def attn_on_summary(rows):
    """The kernel's and the plain composition's bs4 bf16 time summed over
    the three C = 64 blocks of one UNet forward."""
    per = {f"bs4 {H}^2 C=64 heads=2 (ATTN_BLOCK=on)": n for H, n in ATTN_ON_C64}
    mine = [r for r in rows if r["shape"] in per and r["dtype"] == "bfloat16"]
    out = {k: sum(r[k] * per[r["shape"]] for r in mine) for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[attn on C64] attn_block at the three C = 64 blocks of a bs4 bf16 512^2 forward: "
        f"kernel {out['ms']:.4f} ms, plain composition {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def _kernel_name(key: str) -> str:
    """A profiler kernel name without namespaces or parameters, with its
    template arguments (pass 1 and pass 2 of one template stay apart)."""
    for drop in ("void ", "(anonymous namespace)::", "fd::"):
        key = key.replace(drop, "")
    return key.split("(")[0]


def gn_split(card):
    """Phase 2: the device time of each launch of the GroupNorm pair, by
    kernel (``torch.profiler``), over the 38 epilogues of a bs1 fp32 vanilla
    UNet forward: ``group_norm_silu`` on the kernel route at each (H, C) of
    GN_BLOCKS as block1 calls it (the time scale/shift as ``.chunk`` views)
    and as block2 calls it (the residual), 10 calls of each; and the
    launches of one epilogue, the port's and PyTorch's."""
    from torch.profiler import ProfilerActivity, profile

    from founddiff_tpu_torch.ops.groupnorm import group_norm_silu

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(38)
    ms_by, n_by, per_epilogue = {}, {}, {}
    with routes_on(FOUNDDIFF_GN=ROUTES["FOUNDDIFF_GN"]):
        for (H, C), n in GN_BLOCKS.items():
            for ss in (True, False):
                x, g, b, ms, mt = _gn_operands(1, H, C, ss, torch.float32, gen, dev)
                x = x.view(1, H, H, C)
                r = None if ss else _n(gen, (1, H, H, C), 1.0, dev)
                pair = (ms, mt) if ss else None
                fn = lambda: group_norm_silu(x, g, b, residual=r, scale_shift=pair)
                fn()
                torch.cuda.synchronize()
                for _ in range(3):  # a profile now and then comes back without device events
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
                    if events:
                        break
                else:
                    raise AssertionError(f"GroupNorm split at {H}^2 C={C}: no device events")
                for e in events:  # launches a call rounded: the profiler may drop an event
                    k, per_call = _kernel_name(e.key), max(1, round(e.count / 10))
                    ms_by[k] = (ms_by.get(k, 0.0)
                                + e.self_device_time_total / 1e3 / e.count * per_call * n)
                    n_by[k] = n_by.get(k, 0) + per_call * n
                    group = next((name for name, match in PROFILE_GROUPS if match(e.key)),
                                 "other PyTorch kernels")
                    per_epilogue[group] = per_epilogue.get(group, 0) + per_call * n
                del x, r, pair, ms, mt
    calls = 2 * sum(GN_BLOCKS.values())
    per_epilogue = {k: v / calls for k, v in per_epilogue.items()}
    for k in sorted(ms_by, key=lambda k: -ms_by[k]):
        log(f"[split] GroupNorm per bs1 fp32 vanilla forward ({calls} epilogues): {k} "
            f"{ms_by[k]:.4f} ms in {n_by[k]:.0f} launches, {1e3 * ms_by[k] / n_by[k]:.2f} us a "
            f"launch [{card}]")
    log(f"[split] GroupNorm launches per epilogue on the kernel route: {per_epilogue}")
    if per_epilogue != {"port kernels": 2}:  # one C call, two launches, nothing of PyTorch's
        raise AssertionError(f"GroupNorm epilogue launches {per_epilogue}, want 2 of the port's")
    torch.cuda.empty_cache()
    return dict(device_ms=ms_by, launches=n_by, launches_per_epilogue=per_epilogue)


# the units beside the kernels line's bs1 bf16 forward: (kernel, unit,
# batch, dtype, calls of a phase-2 row's count per unit)
UNITS = (("scan_fused_forward", "bs4 bf16 forward", 4, "bfloat16", 1),
         ("scan_fused_forward", "fp32 step", TRAIN_BATCH, "float32", 2),
         ("merge_ln_gate", "bs4 bf16 forward", 4, "bfloat16", 1),
         ("flash_bwd_dq", "bf16 step", TRAIN_BATCH, "bfloat16", 1),
         ("flash_bwd_dkv", "bf16 step", TRAIN_BATCH, "bfloat16", 1))


def unit_totals(rows, card):
    """Time, bound and plain time of the redesigned kernels summed over the
    calls of each of UNITS (phase-2 rows at their main-path shapes), and the
    library call's time where the rows have one."""
    out = {}
    for k, unit, batch, dtype, per in UNITS:
        mine = [r for r in rows if (r["kernel"], r["batch"], r["dtype"]) == (k, batch, dtype)
                and r["per_forward"]]
        keys = ("ms", "bound_ms", "plain_ms") + (
            ("library_ms",) if mine[0]["library_ms"] is not None else ())
        tot = {key: sum(r[key] * r["per_forward"] * per for r in mine) for key in keys}
        out.setdefault(k, {})[unit] = tot
        lib = f", library {tot['library_ms']:.4f} ms" if "library_ms" in tot else ""
        log(f"[unit] {k} per {unit}: kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} "
            f"ms, plain {tot['plain_ms']:.4f} ms{lib} [{card}]")
    return out


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
    forward, 6d for dq and 8d for dk/dv (the products, at PEAK_FLOPS of the
    io dtype: bf16 on the tensor cores, fp32 as three TF32 products) and one
    exponential per (i, j) on the SFUs."""
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


def _flash_spec():
    """(batch, kernel, Lq, Lk, calls per forward or step) of the flash
    kernels: the forward at bs1 (one call per vanilla UNet forward when
    serving) and at the training microbatch of 2, the backward at 2 (two
    calls per train step), and all three at a ragged Lq 1000 / Lk 777 that
    the main path does not run (0 calls)."""
    L = FLASH_L
    spec = [(1, "flash_fwd", L, L, 1), (TRAIN_BATCH, "flash_fwd", L, L, 0)]
    spec += [(TRAIN_BATCH, k, L, L, 2) for k in FLASH_BWD]
    return spec + [(TRAIN_BATCH, k, 1000, 777, 0) for k in ("flash_fwd",) + FLASH_BWD]


def flash_cases():
    """(batch, kernel, label, calls per forward or step, case function) of
    _flash_spec."""
    return [(B, k, f"B{B} H{FLASH_HEADS} Lq={Lq} Lk={Lk} d={FLASH_D}", n,
             lambda dt, g, d, k=k, B=B, Lq=Lq, Lk=Lk: flash_case(k, B, Lq, Lk, dt, g, d))
            for B, k, Lq, Lk, n in _flash_spec()]


def flash_bwd_parts():
    """The parts each phase-2 launch of the backward kernels splits the
    other side into (dq: the keys, dk/dv: the queries), as the library
    chooses them on this card."""
    import ctypes

    from founddiff_tpu_torch.ops import _build

    fn = _build.load("flash_attention").flash_bwd_parts
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    out = {}
    for B, k, Lq, Lk, _ in _flash_spec():
        if k not in FLASH_BWD:
            continue
        for dtype, code in (("float32", 0), ("bfloat16", 1)):
            dkv = k == "flash_bwd_dkv"
            n = fn(B * FLASH_HEADS, Lk if dkv else Lq, code)
            label = f"{k} B{B} H{FLASH_HEADS} Lq={Lq} Lk={Lk} {dtype}"
            out[label] = n
            log(f"[parts] {label}: {n} {'query' if dkv else 'key'} parts a block")
    return out


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


def _gn_operands(B, H, C, ss, dtype, gen, dev):
    """x [B, H*H, C] at the io dtype, the GroupNorm affine [C] and, with
    ``ss``, the time scale/shift as the ``.chunk`` views of one [B, 2C]
    tensor (the time MLP's output, rows of stride 2C), else (None, None)."""
    x = _n(gen, (B, H * H, C), 1.5, dev).add_(0.3).to(dtype)
    g, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
    ms, mt = _n(gen, (B, 2 * C), 0.2, dev).chunk(2, dim=-1) if ss else (None, None)
    return x, g, b, ms, mt


def gn_stats_case(B, H, C, ss, dtype, gen, dev, groups=GN_GROUPS):
    """gn_stats as an epilogue calls it: block1's with the time scale/shift,
    block2's (and the ResnetBlocks') without; its output, the [B, 2, C]
    coefficient table."""
    x, g, b, ms, mt = _gn_operands(B, H, C, ss, dtype, gen, dev)
    # x read once, [B, 2, C] fp32 written; a sum and a square-add per element
    # (the row's bound as first defined, kept so its times compare across versions)
    moved = nbytes(x) + 4 * 2 * B * C
    # no library row of its own: the pair's F.group_norm stands in gn_apply's
    return (x, g, b, ms, mt, groups, 1e-5), {}, None, moved, [(3 * x.numel(), FP32_FLOPS)]


def gn_apply_case(B, H, C, res, dtype, gen, dev, groups=GN_GROUPS):
    """gn_apply as the Blocks call it: with the residual (block2, the
    ResnetBlocks) or, without one, with the time scale/shift folded into the
    table (block1); the table from the plain stats."""
    from founddiff_tpu_torch.ops.groupnorm import gn_stats_plain

    x, g, b, ms, mt = _gn_operands(B, H, C, not res, dtype, gen, dev)
    table = gn_stats_plain(x, g, b, ms, mt, groups, 1e-5)
    r = _n(gen, (B, H * H, C), 1.0, dev).to(dtype) if res else None
    # x (and the residual) read, y written at the io dtype, four [B, C] fp32
    # (the row's bound as first defined, kept so its times compare across versions); per
    # element about 10 fp32 operations and one exponential
    moved = nbytes(x, r) + nbytes(x) + 4 * 4 * B * C
    work = [(10 * x.numel(), FP32_FLOPS), (x.numel(), SFU_EXP_PER_S)]
    return ((x, table, r), {}, r, moved, work,
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
    # (H, C, groups, calls per bs1 vanilla forward): GN_BLOCKS, then edges no
    # forward of phase 11 runs: groups 4, and the ResnetBlocks of a 360^2
    # slice at its top (360^2) and deepest (45^2) scale
    gn = [(H, C, GN_GROUPS, n) for (H, C), n in GN_BLOCKS.items()]
    gn += [(128, 128, 4, 0), (ODD_SIZE, 64, GN_GROUPS, 0), (ODD_SIZE // 8, 512, GN_GROUPS, 0)]
    for H, C, G, n in gn:
        edge = "" if G == GN_GROUPS else f" groups={G}"
        for res in (True, False):
            variant = "res" if res else "scale/shift"
            cases.append(("gn_stats", f"bs{B} {H}^2 C={C} {variant}{edge}", n,
                          lambda dt, g, d, H=H, C=C, G=G, res=res: gn_stats_case(
                              B, H, C, not res, dt, g, d, G)))
            cases.append(("gn_apply", f"bs{B} {H}^2 C={C} {variant}{edge}", n,
                          lambda dt, g, d, H=H, C=C, G=G, res=res: gn_apply_case(
                              B, H, C, res, dt, g, d, G)))
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
            # the plain version is no yardstick of speed: 3 timed calls
            pms = cuda_ms(lambda: plain(*args, **kw), reps=3, warm=1)
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


@contextlib.contextmanager
def swapped(swaps):
    """``swaps``: {(module, name): fn}, each attribute set for the block and
    restored after it (the plain path: each wrapper's plain version in the
    module that calls it)."""
    saved = {k: getattr(*k) for k in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def check_autograd(plain, wrappers, tag="autograd", shapes=((256, 128, 8), (64, 512, 32))):
    """Phases 6, 10 and 13: d(sum(out * w))/d(x, every parameter) of one
    MambaBlock at each (H = W, C, d_state) of ``shapes`` (by default 256^2 C
    128 and 64^2 C 512), batch 2, fp32, through the kernel path and through
    the plain path (``plain``: the swaps of :func:`swapped`, the plain
    versions, which autograd differentiates directly).  On the default
    route the first default block takes the image scan and the second the
    decimated scan in its backward."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.ss2d import MambaBlock

    dev = torch.device("cuda")
    result, failed = {}, []
    for H, C, N in shapes:
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
        with swapped(plain):
            g_plain = grads()
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
    ``torch.profiler``: their device-busy and wall time against the
    device-busy time of one such forward (phase 8's profile), and each
    route's launches per epilogue, the port's and PyTorch's."""
    from founddiff_tpu_torch.ops.groupnorm import group_norm_silu

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(38)
    calls = []
    for (H, C), n in GN_BLOCKS.items():
        x, r = (_n(gen, (1, H, H, C), 1.0, dev) for _ in range(2))
        g, b = _n(gen, (C,), 0.1, dev).add_(1.0), _n(gen, (C,), 0.1, dev)
        ss = _n(gen, (1, 2 * C), 0.2, dev).chunk(2, dim=-1)  # as the time MLP's output
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
                             share_of_forward_busy=prof["busy_ms"] / forward_busy_ms,
                             launches_per_epilogue={g: c / len(calls) for g, (c, _)
                                                    in prof["groups"].items()})
    log(f"[vanilla gn] the 38 GroupNorm epilogues of one bs1 fp32 vanilla forward, device-busy: "
        f"default route {result['default']['busy_ms']:.3f} ms "
        f"({100 * result['default']['share_of_forward_busy']:.1f}% of the forward's "
        f"{forward_busy_ms:.2f} ms in phase 8), the two kernels "
        f"{result['kernels']['busy_ms']:.3f} ms "
        f"({100 * result['kernels']['share_of_forward_busy']:.1f}%); wall "
        f"{result['default']['wall_ms']:.3f} / {result['kernels']['wall_ms']:.3f} ms; launches "
        f"per epilogue {result['default']['launches_per_epilogue']} / "
        f"{result['kernels']['launches_per_epilogue']} [{card}]")
    return dict(result, forward_busy_ms=forward_busy_ms)


def plain_gate(request, x, plain, wrappers, tag, steps):
    """The numerics gate of phases 4 and 12: the request of seed 7 through
    the kernel path and through the plain path (``plain``: the swaps of
    :func:`swapped`; it must launch no kernel), PSNR >= 40 dB on the [0, 1]
    output window."""
    fused = request(x, 7)
    for fn in wrappers.values():
        fn.launches = 0
    with swapped(plain):
        t0 = time.perf_counter()
        ref = request(x, 7)
        t_plain = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    if launched:
        raise AssertionError(f"{tag}: the plain path launched kernels {launched}")
    gate_db = psnr(fused, ref)
    max_diff = float((fused - ref).abs().max())
    size = x.shape[1]
    log(f"[{tag} gate] DDIM-{steps} {size}^2 bs{len(x)} bf16 kernel vs plain path: PSNR "
        f"{gate_db:.2f} dB (gate {PSNR_GATE_DB}), max |diff| {max_diff:.3e}, plain path "
        f"{t_plain:.2f} s")
    if not (math.isfinite(max_diff) and gate_db >= PSNR_GATE_DB):
        raise AssertionError(f"{tag} numerics gate failed: {gate_db:.2f} dB")
    return dict(psnr_db=gate_db, threshold_db=PSNR_GATE_DB, max_abs_diff=max_diff)


def five_level(wrappers, plain, x, card):
    """Phase 15: ``Config()`` with ``dim_mults`` (1, 2, 4, 8, 16), built on
    the card through ``FoundDiffDenoiser`` (the factory keeps base_d_state
    4, so level 4 has d_state 64): one bs1 bf16 request of a 512^2 slice,
    checked as phase 3 with PER_FORWARD_5 launches per UNet forward, the
    plain-path gate of phase 4, and phase 6's autograd check on one
    MambaBlock of that level (32^2, C 512, d_state 64)."""
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    cfg = Config()
    cfg.model.dim_mults = FIVE_MULTS
    diffusion, model = build(cfg, device="cuda", seed=0)
    perturb_gates(model, seed=0)
    states = sorted({m.mamba.d_state for m in model.modules() if hasattr(m, "mamba")})
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=torch.bfloat16)
    steps = cfg.diffusion.sampling_timesteps

    def request(x, seed):
        out = sampler(x, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return out

    request(x, 0)  # warm-up
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = request(x, 100)
    request_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in launches.items():
        if n != PER_FORWARD_5.get(k, 0) * steps:
            raise AssertionError(f"five-level: {k} {n} launches in {steps} UNet forwards, want "
                                 f"{PER_FORWARD_5.get(k, 0)} per forward")
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"five-level: bad output {tuple(out.shape)}")
    log(f"[five-level] dim 64 x {FIVE_MULTS}, d_state {states}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters: DDIM-{steps} "
        f"512^2 bs1 bf16 request {request_s:.4f} s, launches {launches} [{card}]")
    gate = plain_gate(request, x, plain, wrappers, "five-level", steps)
    del model, diffusion, sampler
    torch.cuda.empty_cache()
    grads = check_autograd(plain, wrappers, "autograd d_state 64",
                           shapes=((32, N64[0][0], N64[0][1]),))
    return dict(d_states=states, request_s=request_s, launches=launches, gate=gate,
                autograd=grads)


def beside_parent(tag, train, card) -> None:
    """The fp32 step of ``train_full_width`` beside the parent tree's."""
    log(f"[{tag}] fp32 step {statistics.median(train['step_s']):.4f} s; the parent tree's "
        f"{' / '.join(f'{t:.4f}' for t in PARENT_STEP_S[train['size']])} s "
        f"(scripts/port_ab.py, two turns) [{card}]")


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
    from founddiff_tpu_torch.ops import ss2d_fused as fused_mod

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
    for kname, regs, spill in runtime_n_ptxas(built["logs"]["scan"]):
        log(f"[ptxas scan] {kname}: {regs} registers, {spill} bytes spill stores")

    # gn_stats returns the [B, 2, C] table: held as its two halves, each
    # against its own scale
    halves = lambda fn: lambda *a: tuple(fn(*a).unbind(1))
    ops = {
        "ss2d_image_block": (ss2d_mod.ss2d_image_block, ss2d_mod.ss2d_image_block_plain),
        "attn_block": (attn_mod.attn_block, attn_mod.attn_block_plain),
        "layer_norm_modulated": (norm_mod.layer_norm_modulated,
                                 norm_mod.layer_norm_modulated_plain),
        "scan_forward": (scan_mod.scan_forward, lambda *a: scan_mod.scan_forward_plain(
            *a, scan_mod.scan_chunk(a[2].shape[-1]))),
        "scan_forward bounds-only": (
            lambda *a: scan_mod.scan_forward(*a, bounds_only=True)[1],
            lambda *a: scan_mod.scan_forward_plain(*a, scan_mod.scan_chunk(a[2].shape[-1]))[1]),
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
        "scan_fused_forward": (scan_mod.scan_fused_forward,
                               lambda *a: scan_mod.scan_fused_forward_plain(
                                   *a, scan_mod.scan_chunk(a[4].shape[-1]))),
        "layer_norm": (norm_mod.layer_norm, norm_mod.layer_norm_plain),
        # the epilogue on either layout: one kernel, one launch count
        "merge_ln_gate": (
            lambda *a, split, **k: (fused_mod.merge_ln_gate_split if split
                                    else fused_mod.merge_ln_gate)(*a, **k),
            lambda *a, split, **k: (fused_mod.merge_ln_gate_split_plain if split
                                    else fused_mod.merge_ln_gate_plain)(*a, **k)),
    }
    wrappers = {k: getattr(mod, k) for k, mod in (
        ("ss2d_image_block", ss2d_mod), ("attn_block", attn_mod),
        ("layer_norm_modulated", norm_mod), ("scan_forward", scan_mod),
        ("scan_backward", scan_mod), ("scan_image_forward", scan_mod), ("flash_fwd", flash_mod),
        ("flash_bwd_dq", flash_mod), ("flash_bwd_dkv", flash_mod), ("gn_stats", gn_mod),
        ("gn_apply", gn_mod), ("ss2d_mamba_block", unified_mod),
        ("scan_fused_forward", scan_mod), ("layer_norm", norm_mod),
        ("merge_ln_gate", fused_mod))}

    # phase 2: kernels against their plain versions
    cases = [(b, *c) for b in (1, 4) for c in kernel_cases(b)]
    cases += [(TRAIN_BATCH, *c) for c in train_cases()]
    cases += flash_cases()
    cases += [(b, *c) for b in (1, TRAIN_BATCH, 4) for c in route_cases(b)]
    cases += [(b, *c) for b in (1, TRAIN_BATCH, 4) for c in unfused_cases(b)]
    cases += slice6_cases()
    cases += slice7_cases()
    cases += attn_on_cases()
    rows, failed = check_kernels(ops, cases)
    bounds, bounds_failed = check_fused_h_bounds()
    failed += bounds_failed
    bounds_only, bounds_only_failed = check_bounds_only(cases)
    failed += bounds_only_failed
    record = dict(card=card, build_seconds=built["seconds"], ptxas=built["logs"],
                  kernel_cases=rows, fused_h_bounds=bounds, bounds_only=bounds_only,
                  attn_on_c64=attn_on_summary(rows), split=gn_split(card),
                  units=unit_totals(rows, card), flash_bwd_parts=flash_bwd_parts())
    if failed:
        _write_record(record)
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    # phase 3: the main path at full width
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.models import blocks as blocks_mod
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
    plain_default = {(ss2d_model, "ss2d_image_block"): ss2d_mod.ss2d_image_block_plain,
                     (ss2d_model, "attn_block"): attn_mod.attn_block_plain,
                     (ss2d_model, "layer_norm_modulated"): norm_mod.layer_norm_modulated_plain}
    record["gate"] = plain_gate(request, x_all[:1], plain_default, wrappers, "main", steps)

    # phase 5: where the device time of one request goes
    record["profile"] = {f"bs{len(x)}": profile_device(lambda: request(x, 9), f"bs{len(x)}")
                         for x in (x_all[:1], x_all)}

    # phase 6: autograd through the kernels against the plain path
    record["autograd"] = check_autograd(plain_default, wrappers)
    # phase 7: training at full width
    record["train"] = train_full_width(wrappers, card, Config(), PER_STEP, "train")
    beside_parent("train", record["train"], card)
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
            {**plain_default,
             (ss2d_model, "ss2d_mamba_block"): unified_mod.ss2d_mamba_block_plain},
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

    # phase 12: serving slices whose deepest grid is odd (360^2), and 16^2
    plain_all = {**plain_default,
                 (ss2d_model, "selective_scan_fused"): scan_mod.selective_scan_fused_plain,
                 (ss2d_model, "scan_image"): scan_mod.scan_image_forward_plain,
                 (ss2d_model, "merge_ln_gate"): fused_mod.merge_ln_gate_plain,
                 (ss2d_model, "merge_ln_gate_split"): fused_mod.merge_ln_gate_split_plain,
                 (blocks_mod, "layer_norm"): norm_mod.layer_norm_plain}
    x_odd = torch.from_numpy(np.random.default_rng(1).random(
        (4, ODD_SIZE, ODD_SIZE, 1), dtype=np.float32)).cuda()
    record["odd"], _ = serve_requests(request, x_odd, wrappers, PER_FORWARD_360, steps,
                                      f"odd {ODD_SIZE}")
    odd = record["odd"]
    log(f"[odd {ODD_SIZE}] DDIM-{steps} {ODD_SIZE}^2 bf16: bs1 {odd['bs1_slices_per_s']:.3f} "
        f"slices/s (request s {[round(t, 4) for t in odd['bs1_request_s']]}), bs4 "
        f"{odd['bs4_slices_per_s']:.3f} slices/s (batch s "
        f"{[round(t, 4) for t in odd['bs4_batch_s']]}), peak memory "
        f"{odd['peak_memory_gib']:.2f} GiB [{card}]")
    odd["gate"] = plain_gate(request, x_odd[:1], plain_all, wrappers, f"odd {ODD_SIZE}",
                             steps)
    odd["profile"] = {f"bs{len(x)}": profile_device(lambda: request(x, 9),
                                                    f"odd {ODD_SIZE} bs{len(x)}")
                      for x in (x_odd[:1], x_odd)}
    x_small = torch.from_numpy(np.random.default_rng(2).random(
        (4, EPI_SIZE, EPI_SIZE, 1), dtype=np.float32)).cuda()
    record["small"], _ = serve_requests(request, x_small, wrappers, PER_FORWARD_16, steps,
                                        f"small {EPI_SIZE}")
    record["small"]["gate"] = plain_gate(request, x_small[:1], plain_all, wrappers,
                                         f"small {EPI_SIZE}", steps)
    # phase 13: autograd on the unfused and the epilogue routes
    record["unfused_autograd"] = check_autograd(
        plain_all, wrappers, "autograd unfused",
        shapes=((45, DEEP[0][0], DEEP[0][1]), (2, DEEP[1][0], DEEP[1][1])))
    # phase 14: training at 360^2
    cfg_odd = Config()
    cfg_odd.diffusion.image_size = ODD_SIZE
    record["train_odd"] = train_odd = train_full_width(wrappers, card, cfg_odd, PER_STEP_360,
                                                       f"train {ODD_SIZE}")
    beside_parent(f"train {ODD_SIZE}", train_odd, card)
    # phase 15: a five-level UNet, d_state 64 at its 32^2 level
    torch.cuda.empty_cache()
    record["five_level"] = five_level(wrappers, plain_default, x_all[:1], card)

    kernels = []
    for k, (src, tpu) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == k]
        if k in SERVING:  # one bs1 bf16 UNet forward
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = main["launches"][k]
        elif k == "ss2d_mamba_block":  # one bs1 bf16 UNet forward, both routes on
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = record["routes"]["launches"][k]
        elif k in ("scan_fused_forward", "layer_norm", "merge_ln_gate"):
            # one bs1 bf16 UNet forward at 360^2 (the epilogue: at 16^2)
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = record["small" if k == "merge_ln_gate" else "odd"]["launches"][k]
        elif k in ("flash_fwd",) + GN:  # one bs1 fp32 vanilla UNet forward
            main_rows = [r for r in mine if r["dtype"] == "float32" and r["batch"] == 1]
            n = record["vanilla_gn" if k in GN else "vanilla"]["launches"][k]
        else:  # one fp32 train step
            main_rows = [r for r in mine if r["dtype"] == "float32"]
            n = record["vanilla_train" if k in FLASH_BWD else "train"]["launches"][k]
        total = lambda key: sum(r[key] * r["per_forward"] for r in main_rows)
        states = sorted({int(w[2:]) for r in mine for w in r["shape"].split()
                         if w.startswith("N=")})
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=tpu, launches=n,
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms") if main_rows[0]["library_ms"] is not None else None,
            **({"d_state": states} if states else {}),
            **({"units": record["units"][k]} if k in record["units"] else {})))
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
