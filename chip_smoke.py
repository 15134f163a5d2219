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
   its full mode's, bit for bit, at every scan_forward shape of phase 2,
   and its last-state mode (``last_state=True``: ``h_last`` against the
   plain version's at phase 2's tolerance, y and h_bounds bit for bit
   those of the mode without it).
   ``attn_block`` at the three C = 64 MambaBlocks of a 512^2 slice (512^2
   and 256^2 at bs4) summed, beside the plain composition it replaces there;
   the device time of each launch of the GroupNorm pair, redesigned last
   (``torch.profiler``), over the 38 epilogues of a bs1 fp32 vanilla UNet
   forward on the kernel route, and the launches of one epilogue; the
   summed times and bounds of ``scan_fused_forward`` and ``merge_ln_gate``
   per bs4 forward and (``scan_fused_forward``) per fp32 step, and of the
   two flash backward kernels per bf16 step beside SDPA's backward; and the
   key (``flash_bwd_dq``) or query (``flash_bwd_dkv``) parts each phase-2
   backward launch splits the other side into (``[parts]`` lines).
   The model options' call sites (phase 18): ``ss2d_image_block`` with
   ``silu_input`` (``FOUNDDIFF_SILU=kernel``, the raw dwconv output in) at
   every main-path shape at bs1 and bs4; at the first level of ``Config()``
   (C0 64 on 512^2, d_state 4, bs1) ``scan_image_forward`` before the
   un-folded epilogue, ``merge_ln_gate`` without the fold,
   ``scan_fused_forward`` on v0's four full sequences (L 262,144) and on
   step 3's (L 29,241); and ``flash_fwd`` of a self-attending
   ``CrossAttention`` on a 64^2 grid (L 4,096) at bs1 and bs4.
3. Main path at full width: ``build(Config())`` on the card (dim 64 x
   (1, 2, 4, 8), full RN50 CLIPIQA tower, seeded random weights with
   non-zero adaLN and prompt), ``make_hoisted_sampler(...,
   compute_dtype=torch.bfloat16)``, 2-step DDIM on 4 requests of one 512^2
   slice and 2 batches of 4.  Checks the outputs and the launch counts of
   each kernel (9 ``ss2d_image_block``, 9 ``attn_block`` and 9
   ``layer_norm_modulated`` per UNet forward: no gradient is recorded, so
   every attention half takes the fused kernel); prints slices/s and peak
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
16. The evaluation entry point, in process, in a working directory under
   ``checkpoints/`` that phase 19 removes after it: a synthetic Mayo-2020 ``test``
   tree of 512^2 HU slices (``default_rng(16)``; ab, lung and head, doses 2,
   4, 6 and 10 with the quarter-dose scan for 1/4 or 1/10, 32 LDCT slices,
   ``eval_counts`` set to match), a ``model-1.pt`` of ``Config()`` written by
   ``Trainer.save`` (seed 16, adaLN and prompt perturbed as in phase 3,
   the tower's batch-norm statistics set from 8 of the tree's slices), then ``founddiff_tpu_torch.cli.main`` in test mode (``--torch_checkpoint``,
   ``--dataset 2020_seen``): 32 predictions of 512 x 512, the per-anatomy
   and per-dose log lines, a finite summary, phase 3's launches per UNet
   forward over the 64 fp32 forwards; ``Trainer.test`` twice more (eval
   slices/s: data, sampling and metrics, median of the 2; the native reader
   must have decoded every file of both) and with ``fid=True``: the
   Dose-CLIP features of its 32 predictions and NDCT slices on the card
   within 1e-3 of the CPU's (relative to their largest magnitude), its
   ``fid_doseclip`` within 1e-2 relative of the CPU's FID of the same
   slices, above 100 times the eps offset, with a median feature spread
   over the NDCT slices of at least 1e-2; 4 slices through the plain
   path as phase 4 switches it, PSNR >= 40 dB against the kernel path, and
   their PSNR/SSIM/RMSE on the card within 1e-4 of the CPU's; full-T
   ``p_sample_loop`` (T = 50) of one slice with its launches; test mode
   with ``--no_dose_encoder`` on 8 Mayo-2016 pairs (``ResidualDiffusion.sample``);
   train mode (``--is_train --debug``, 4 steps of 2 slices at 512^2) with
   ``train.log``, ``metrics.jsonl`` and the previews ``sample-1`` and
   ``sample-2``.
17. Distribution (``founddiff_tpu_torch.parallel``): (a) the
   sequence-sharded composition in one process at 2 and 4 virtual shards of
   the 512^2 first level's scan operands (B 1, K 4, L 65,536, D 128, N 4,
   fp32), ``local_summary`` (``scan_forward`` with its last state, one
   launch a shard) then ``apply_prefix``, against the unsharded kernel scan
   and the plain chunked scan (rtol 2e-4 / atol 2e-5), with the
   correction's time and peak memory; (b) ``init_distributed`` at world
   size 1 over NCCL (a ``FileStore`` rendezvous, rank 0) and
   ``make_mesh()``: one data-parallel fp32 train step of ``Config()`` at
   512^2 (2 x 2 microbatches) against a step without a mesh on the same
   batch and draws (per parameter bit-identical or within 1e-6 relative),
   two more timed beside phase 7's with phase 7's launches per step;
   ``make_volume_denoiser`` of phase 3's model on a seeded volume of 18
   slices of 512^2 in bf16 waves of 4 (slices/s, phase 3's launches per
   UNet forward, every wave bit-identical to the hoisted sampler's on the
   same noise, the plain-path gate of phase 4 on one slice); (c)
   ``python -m founddiff_tpu_torch.tools.denoise_volume`` as a subprocess
   on a ``model-1.pt`` of phase 3's weights and a 4-slice volume: rc 0, the
   output's shape and its summary line.
18. The model and loss options: (a) phase 3's requests with
   ``FOUNDDIFF_SILU=kernel`` (every ``ss2d_image_block`` launch with its
   silu flag, none in phase 3), PSNR >= 40 dB against phase 3's outputs with
   the count of differing elements, the plain-path gate of phase 4, slices/s
   beside phase 3's; (b) phase 7's fp32 train step (1 warm-up, 3 timed)
   under the variable (18 silu launches per step), again with the auxiliary
   weights AUX, s/step beside phase 7's, and autograd as phase 6 under it;
   (c) the auxiliary terms at 4 x 512^2 on the card within 1e-5 relative
   of the CPU's; (d) a no-tower ``UnetRes`` of ``Config()`` at 512^2 with
   ``learned_variance``, ``input_condition`` and ``input_condition_mask``:
   one Adam step on (gt, ld, mask), its sample raising ``TypeError`` as the
   JAX scan does, and the same build without ``learned_variance`` sampling
   DDIM-2 with phase 3's launches per UNet forward; (e) each SS2D variant
   (``use_bias``, ``dropout``, ``conv_bias=False`` with ``d_conv`` 5 and
   ``dt_rank`` 8, v0, step 3 up to its merge, which raises as in JAX) at
   C0 64 on 512^2, ``MambaBlock(cross=True)`` and a self-attending
   ``CrossAttention`` at C 512 on 64^2, kernel path against plain path
   (relative 1e-4, fp32), and ``PatchMerging2D`` there, card against CPU.
19. The Dose-CLIP family and the tools, on phase 16's tree and predictions:
   (a) ``python -m founddiff_tpu_torch.tools.train_doseclip`` as a
   subprocess (``CLIPIQA()``, bs 8 over two views of the 512^2 train512
   slices, 6 steps; steps/s and peak memory from its log): rc 0, every loss
   finite, every ``clip_model.*`` tensor bit for bit the tool's seeded
   start, ``ctx``, ``token_prefix``, ``token_suffix`` and both heads moved;
   one step's three loss terms and the trained tensors' gradients at bs 2,
   card against CPU within 1e-4 relative (the tower's batch-norm statistics
   set from the slices); the written file loaded strictly as phase 3's dose
   encoder and one bs1 bf16 DDIM-2 request, finite, with phase 3's launches;
   (b) ``build_clip_from_state_dict`` on seeded tensors of ViT-B/32's and
   RN50's stock layout (with a stock file's ints and BatchNorm counters),
   tokens from the port tokenizer on ``tests/fixtures/bpe_tiny_vocab.txt.gz``:
   ``CLIP(image, text)`` and the ViT's ``encode_image(pos_embedding=True)``
   at 512^2 (257 tokens against 50), card against CPU within 1e-4; (c) a
   seeded LPIPS at 256^2 bs 4 and ``clip_preprocess`` of 4 x 512^2 slices,
   within 1e-5; (d) the FID tool with (a)'s file (batch-norm statistics set
   from the ground truths) on phase 16's predictions against
   ``compute_fid`` in process within 1e-3 and JAX's keys, the tool without
   weights refusing, ``analyze_results`` against the port's metrics on the
   same files within 1e-5 (the tools compared with TF32 off, as here);
   (e) ``Trainer.train(profile_dir=..., profile_steps=(1, 3))`` over 4 fp32
   steps of ``Config()`` at 512^2: the Chrome trace's port kernels (by the
   sources' ``__global__`` names) each at twice its count in phase 7's
   profiled step, grouped as the units that launch them, the wrappers at
   PER_STEP a step.

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
one; for ``scan_forward`` ``last_state``, its last-state mode's cases,
worst ``h_last`` error and launches on the seq route (phase 17); and for
``scan_fused_forward``, ``merge_ln_gate`` and the two flash
backward kernels ``units``, their time and bound summed over a bs4 bf16
forward, for the scan also over an fp32 360^2 train step, for the flash
backward over a bf16 train step with SDPA's backward beside them); and one
entry for each site of the options (SITES): ``ss2d_image_block
silu_input`` over phase 18's serving (one bs1 bf16 forward), the others
over the one bs1 fp32 call of phase 18's variant that makes it; the
last is ``{"ok": true, "device": {...}}``.
A longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import glob
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
# the __global__ functions of the port's sources, by name
PORT_KERNEL_NAMES = {m.group(1) for path in glob.glob(os.path.join(
    REPO, "founddiff_tpu_torch", "csrc", "*.cu*")) for m in re.finditer(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", open(path).read())}


def is_port_kernel(name: str) -> bool:
    """A profiler kernel name of the port's: in namespace fd or a file's
    top-level anonymous namespace (a profiler name starts with "void " for a
    template kernel, with the namespace for a plain one), and one of the
    sources' __global__ functions (PyTorch has top-level anonymous-namespace
    kernels too: softmax_warp_forward)."""
    return (name.startswith(("void fd::", "void (anonymous namespace)::", "fd::",
                             "(anonymous namespace)::"))
            and _kernel_name(name).split("<")[0] in PORT_KERNEL_NAMES)


# kernel-name groups of the profile, first match wins
PROFILE_GROUPS = (
    ("port kernels", is_port_kernel),
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
# routes on (phase 10): no gradient recorded, so every attention half on
# attn_block (norm2 inside it); norm1 inside the unified op with the routes
PER_FORWARD = {"ss2d_image_block": 9, "attn_block": 9, "layer_norm_modulated": 9}
PER_FORWARD_ROUTES = {"ss2d_mamba_block": 9, "attn_block": 9, "gn_stats": 10, "gn_apply": 10}
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
# block; attn_block at the two 360^2 blocks, C 64: H % 8 != 0 at every other
# scale) and at 16^2 (attn_block at the 16^2 and 8^2 blocks, C 64 and 128)
PER_FORWARD_360 = {"ss2d_image_block": 6, "attn_block": 2, "layer_norm_modulated": 16,
                   "scan_fused_forward": 3, "layer_norm": 3}
PER_FORWARD_16 = {"ss2d_image_block": 6, "attn_block": 4, "layer_norm_modulated": 14,
                  "scan_image_forward": 3, "merge_ln_gate": 3}
# launches per train step at 360^2: the forward twice, the remat backward of
# the six fused blocks on the decimated scan (image_scan_vmem_ok is False at
# every even 360^2 scale), the three unfused blocks' scan backward
PER_STEP_360 = {"ss2d_image_block": 12, "layer_norm_modulated": 36, "scan_fused_forward": 6,
                "layer_norm": 6, "scan_forward": 12, "scan_backward": 18}
# phase 15: a five-level UNet (dim 64 x (1, 2, 4, 8, 16)) at 512^2 puts
# down_4 (C 512), mid and up_0 (C 1024) on a 32^2 grid with d_state 64;
# per UNet forward 11 fused blocks, 11 attention halves (every H % 8 == 0)
# and 11 layer_norm_modulated (norm1)
FIVE_MULTS = (1, 2, 4, 8, 16)
PER_FORWARD_5 = {"ss2d_image_block": 11, "attn_block": 11, "layer_norm_modulated": 11}
N64 = ((512, 64), (1024, 64))  # (C0, d_state) of the 32^2 blocks
# d_state sizes no kernel template holds (padded to 16; two groups of 64)
ODD_STATES = (12, 128)
# phase 18: the model options.  The fused block with FOUNDDIFF_SILU=kernel is
# row 1 with its silu flag; the other sites are calls of rows 6, 7, 8 and 12
# that only the options make.  Each site is its own phase-2 key and its own
# entry of the kernels line: (wrapper, the site's key).
SILU_KERNEL = "ss2d_image_block silu_input"
SITES = (SILU_KERNEL, "scan_image_forward unfolded epilogue", "merge_ln_gate no fold",
         "scan_fused_forward v0", "scan_fused_forward step 3", "flash_fwd CrossAttention")
SITE_WRAPPER = {SILU_KERNEL: "ss2d_image_block", SITES[1]: "scan_image_forward",
                SITES[2]: "merge_ln_gate", SITES[3]: "scan_fused_forward",
                SITES[4]: "scan_fused_forward", SITES[5]: "flash_fwd"}
SOURCES.update({k: SOURCES[w] for k, w in SITE_WRAPPER.items()})
# (H = W, C0, d_state) of the SS2D variants: the first level of Config() at 512^2
VARIANT = (512, 64, 4)
V0_L = 512 * 512  # cross_scan_v0: four full sequences of H * W steps
STEP3_L = 171 * 171  # efficient_scan(x, 3) of a 512^2 grid: ceil(512 / 3)^2 steps
AUX = (0.1, 0.1)  # aux_grad_loss_weight, aux_wavelet_loss_weight of phase 18's steps
AUX_RTOL = 1e-5  # the auxiliary losses on the card against the CPU's, relative
VARIANT_RTOL = 1e-4  # ||kernel - plain|| / ||plain - residual||, fp32
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


def ln_case(B, H, C, dtype, gen, dev):
    """norm1 of a MambaBlock: the affine LayerNorm with adaLN modulation."""
    x = _n(gen, (B, H * H, C), 1.0, dev).add_(0.3).to(dtype)
    g = _n(gen, (C,), 0.1, dev).add_(1.0)
    b = _n(gen, (C,), 0.1, dev)
    ms, mt = _n(gen, (B, C), 0.2, dev), _n(gen, (B, C), 0.2, dev)
    args = (x, g, b, ms, mt)
    kw = dict(eps=1e-5)
    flops = 10 * x.numel()
    return args, kw, None, nbytes(x, g, b, ms, mt) + nbytes(x), [(flops, FP32_FLOPS)]


def ss2d_case(B, H, C0, N, dtype, gen, dev, silu_input=False):
    """The fused block at batch B on an H x H grid; with ``silu_input`` xs
    is the raw dwconv output and the kernel applies the silu."""
    D, R = 2 * C0, -(-C0 // 16)
    P = B * H * H
    dt = torch.exp(torch.rand((4, D), generator=gen) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3)).clamp_min(1e-4)
    x1 = _n(gen, (B, H, H, C0), 1.0, dev).to(dtype)
    raw = _n(gen, (B, H, H, D), 1.0, dev)  # drawn after x1, as before the silu flag
    args = (
        x1,
        (raw if silu_input else torch.nn.functional.silu(raw)).to(dtype),  # xs
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
    work = [(mm, PEAK_FLOPS[dtype]), (scan, FP32_FLOPS)]
    if silu_input:  # the silu of each xs element once: an exponential and 3 operations
        work += [(P * D, SFU_EXP_PER_S), (3 * P * D, FP32_FLOPS)]
    return args, kw, args[2], moved, work


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
    main-path shape at batch B; counts are calls per UNet forward (serving
    records no gradient: every attention half on attn_block, norm2 in it)."""
    cases = []
    ln1, ss, at = {}, {}, {}
    for H, C, N in BLOCKS.values():
        ln1[(H, C)] = ln1.get((H, C), 0) + 1
        ss[(H, C, N)] = ss.get((H, C, N), 0) + 1
        at[(H, C)] = at.get((H, C), 0) + 1
    for (H, C), n in ln1.items():
        cases.append(("layer_norm_modulated", f"bs{B} norm1 {H}^2 C={C}", n,
                      lambda dt, g, d, H=H, C=C: ln_case(B, H, C, dt, g, d)))
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


def scan_image_case(H, C, N, dtype, gen, dev, B=TRAIN_BATCH):
    D, R = 2 * C, -(-C // 16)
    P = B * H * H
    x = torch.nn.functional.silu(_n(gen, (B, H, H, D), 1.0, dev)).to(dtype)
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


def options_cases():
    """(batch, kernel, label, count, make) of the model options' call sites:
    the fused block with ``silu_input`` (``FOUNDDIFF_SILU=kernel``) at every
    main-path shape at bs1 and bs4, counted per UNet forward of phase 18's
    serving; and, counted once per bs1 call of phase 18's SS2D variants and
    its CrossAttention (the first level of ``Config()``: C0 64 on 512^2,
    d_state 4), the image scan before the un-folded epilogue (``use_bias``,
    ``dropout``), the epilogue without the folded out_proj, the
    fused-projection scan of v0's four full sequences and of step 3's,
    and the flash forward of a self-attending CrossAttention on a 64^2 grid
    (also at bs4)."""
    cases = []
    for B in (1, 4):
        ss = {}
        for H, C, N in BLOCKS.values():
            ss[(H, C, N)] = ss.get((H, C, N), 0) + 1
        for (H, C, N), n in ss.items():
            cases.append((B, SILU_KERNEL, f"bs{B} {H}^2 C0={C} D={2 * C} N={N}", n,
                          lambda dt, g, d, B=B, H=H, C=C, N=N: ss2d_case(
                              B, H, C, N, dt, g, d, silu_input=True)))
    H, C0, N = VARIANT
    D = 2 * C0
    L = FLASH_L
    return cases + [
        (1, SITES[1], f"bs1 {H}^2 D={D} N={N}", 1,
         lambda dt, g, d: scan_image_case(H, C0, N, dt, g, d, B=1)),
        (1, SITES[2], f"bs1 split {H}^2 C={D} no fold", 1,
         lambda dt, g, d: epilogue_case(1, H, D, C0, True, False, dt, g, d)),
        (1, SITES[3], f"bs1 L={V0_L} D={D} N={N}", 1,
         lambda dt, g, d: scan_fused_case(1, C0, N, dt, g, d, L=V0_L)),
        (1, SITES[4], f"bs1 L={STEP3_L} D={D} N={N}", 1,
         lambda dt, g, d: scan_fused_case(1, C0, N, dt, g, d, L=STEP3_L)),
        (1, SITES[5], f"B1 H{FLASH_HEADS} Lq={L} Lk={L} d={FLASH_D}", 1,
         lambda dt, g, d: flash_case("flash_fwd", 1, L, L, dt, g, d)),
        (4, SITES[5], f"B4 H{FLASH_HEADS} Lq={L} Lk={L} d={FLASH_D}", 0,
         lambda dt, g, d: flash_case("flash_fwd", 4, L, L, dt, g, d)),
    ]


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



def check_last_state(cases):
    """Row 4's last-state mode, ``scan_forward(..., last_state=True)``, at
    every scan_forward case of phase 2, fp32 and bf16: y and h_bounds bit
    for bit against the mode without it, ``h_last`` [B, K, D, N] against the
    plain version's at phase 2's per-element tolerance (its own dtype,
    fp32)."""
    from founddiff_tpu_torch.ops.scan import scan_chunk, scan_forward, scan_forward_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(47)
    rows, failed = [], []
    for batch, kname, label, count, make in cases:
        if kname != "scan_forward":
            continue
        for dtype in (torch.float32, torch.bfloat16):
            args = make(dtype, gen, dev)[0]
            y, hb = scan_forward(*args)
            y2, hb2, h_last = scan_forward(*args, last_state=True)
            want = scan_forward_plain(*args, scan_chunk(args[2].shape[-1]), last_state=True)[2]
            torch.cuda.synchronize()
            same = torch.equal(y, y2) and torch.equal(hb, hb2)
            err, excess, scale, tol, ok = compare(h_last, want, None, dtype)
            key = f"{label} {str(dtype).replace('torch.', '')}"
            rows.append(dict(case=key, bit_identical=same, max_abs_err=err, err_past_ulp=excess,
                             tol=tol, ok=ok))
            if not (same and ok):
                failed.append(f"scan_forward last_state {key}")
            del args, y, hb, y2, hb2, h_last, want
    log(f"[kernel] scan_forward last_state: y and h_bounds bit-identical to the mode without "
        f"it in {sum(r['bit_identical'] for r in rows)} of {len(rows)} cases; h_last against "
        f"the plain version: worst err {max(r['max_abs_err'] for r in rows):.3e}, "
        f"{sum(r['ok'] for r in rows)} of {len(rows)} within tolerance")
    return rows, failed

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


def attn_on_summary(rows):
    """The kernel's and the plain composition's bs4 bf16 time summed over
    the three C = 64 blocks of one UNet forward (down_0, down_1, up_3): the
    rows of kernel_cases(4) at C 64."""
    mine = [r for r in rows if r["kernel"] == "attn_block" and r["batch"] == 4
            and r["dtype"] == "bfloat16" and r["shape"].endswith(" C=64 heads=2")]
    out = {k: sum(r[k] * r["per_forward"] for r in mine) for k in ("ms", "plain_ms", "bound_ms")}
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

        wrappers.reset()
        g_kernel = grads()
        used = wrappers.used()
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

        wrappers.reset()
        with routes_on(FOUNDDIFF_GN=ROUTES["FOUNDDIFF_GN"]):
            g_kernel = grads()
        used = wrappers.used()
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


def train_full_width(wrappers, card, cfg, per_step, tag, full=True, aux=None):
    """Phases 7, 9, 10, 11 and 18: ``Trainer.train_step`` of ``cfg`` on the
    card.  ``per_step``: the launches per step of the path's kernels (every
    other kernel 0).  ``full=False`` (the routed phases) takes the warm-up
    and the three timed fp32 steps only: no profiled step and no bf16
    steps.  ``aux``: the diffusion's (aux_grad_loss_weight,
    aux_wavelet_loss_weight)."""
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.train.trainer import Trainer

    cfg.train.checkpoint_folder = os.path.join(REPO, "chiprun_out", tag.replace(" ", "_"))
    diffusion, model = build(cfg, device="cuda", seed=0, train=True)
    if not cfg.model.original_ddim_ddpm:
        perturb_gates(model, seed=0)
    if aux is not None:
        diffusion.aux_grad_loss_weight, diffusion.aux_wavelet_loss_weight = aux
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
        wrappers.reset()
        t0 = time.perf_counter()
        losses = trainer.train_step(b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for k, n in wrappers.counts().items():
            counts.setdefault(k, []).append(n)
        counts.setdefault("ss2d_image_block silu_input", []).append(
            wrappers.silu())
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
    wrappers.reset()
    t0 = time.perf_counter()
    out = sample(0)
    t_sample = time.perf_counter() - t0
    launches = wrappers.counts()
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

    wrappers.reset()
    g_kernel = grads()
    used = wrappers.used()
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
    wrappers.reset()
    t_bs1, t_bs4, outs = [], [], []
    for i in range(4):
        t0 = time.perf_counter()
        outs.append(request(x_all[i:i + 1], 100 + i))
        t_bs1.append(time.perf_counter() - t0)
    for i in range(2):
        t0 = time.perf_counter()
        outs.append(request(x_all, 200 + i))
        t_bs4.append(time.perf_counter() - t0)
    launches = wrappers.counts()
    launches_silu = wrappers.silu()
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
        f"({per_forward} per forward), {launches_silu} ss2d_image_block with silu_input")
    return dict(launches=launches, launches_silu=launches_silu, forwards=forwards, bs1_slices_per_s=sps1,
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
    wrappers.reset()
    with swapped(plain):
        t0 = time.perf_counter()
        ref = request(x, 7)
        t_plain = time.perf_counter() - t0
    launched = wrappers.used()
    if launched:
        raise AssertionError(f"{tag}: the plain path launched kernels {launched}")
    gate_db = psnr(fused, ref)
    max_diff = float((fused - ref).abs().max())
    # PSNR reads inf when every element agrees: the count says how many do not
    differing = int((fused != ref).sum())
    size = x.shape[1]
    log(f"[{tag} gate] DDIM-{steps} {size}^2 bs{len(x)} bf16 kernel vs plain path: PSNR "
        f"{gate_db:.2f} dB (gate {PSNR_GATE_DB}), max |diff| {max_diff:.3e}, differing "
        f"elements {differing} of {fused.numel()}, plain path {t_plain:.2f} s")
    if not (math.isfinite(max_diff) and gate_db >= PSNR_GATE_DB):
        raise AssertionError(f"{tag} numerics gate failed: {gate_db:.2f} dB")
    return dict(psnr_db=gate_db, threshold_db=PSNR_GATE_DB, max_abs_diff=max_diff,
                differing=differing, elements=fused.numel())


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
    wrappers.reset()
    t0 = time.perf_counter()
    out = request(x, 100)
    request_s = time.perf_counter() - t0
    launches = wrappers.counts()
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


# phase 16: a synthetic Mayo-2020 tree (the reference's names, 512^2 HU
# slices): (top directory, files per dose directory) of each anatomy; ab and
# lung take every second file (stride 2), head every one, so 3 / 3 / 2 LDCT
# slices a dose and 32 in all over doses (2, 4, 6, 10), the quarter-dose scan
# standing in for 1/4 (ab, head) and 1/10 (lung)
EVAL_TREE = {"ab": ("Mayo2020_ab_2d", 6), "lung": ("Mayo2020_lung_2d", 6),
             "head": ("Mayo2020_head_2d_2", 2)}
EVAL_COUNTS = (("ab", 3), ("lung", 3), ("head", 2))
EVAL_DOSE_DIRS = {"full_1mm": 1.0, "sim-0.50": 2.0, "sim-0.25": 4.0, "sim-0.17": 6.0,
                  "sim-0.10": 10.0, "quarter_1mm": 4.0}
EVAL_SIZE = 512
EVAL_NO_TOWER = 8  # Mayo-2016 pairs of the no-tower run
EVAL_FULL_T = 50  # timesteps = sampling_timesteps of the full-T sample


def write_eval_tree(root, phase, files, seed):
    """Mayo-2020 ``phase`` tree at 512^2: per index a phantom (an ellipse of
    soft tissue with four disks, raw HU + 1024, in air), its full-dose scan
    with noise sigma 10 HU and each simulated dose with sigma 10 * sqrt(1 /
    dose), from ``default_rng(seed)``; ``files`` overrides the files per dose
    directory."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:EVAL_SIZE, :EVAL_SIZE] / EVAL_SIZE - 0.5
    for anat, (top, n) in EVAL_TREE.items():
        for i in range(files or n):
            body = (xx / 0.42) ** 2 + (yy / 0.34) ** 2 < 1
            hu = np.where(body, 40.0, -1000.0)
            for _ in range(4):
                cx, cy, r = rng.uniform(-0.25, 0.25), rng.uniform(-0.2, 0.2), rng.uniform(0.02, 0.08)
                hu[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = rng.uniform(-900.0, 1200.0)
            for d, factor in EVAL_DOSE_DIRS.items():
                path = os.path.join(root, top, phase, d)
                os.makedirs(path, exist_ok=True)
                name = (f"{anat}-{d}-{i}.npy" if not d.startswith("sim") else
                        f"{anat}-sim-{d.split('-')[1]}-{i}.npy")
                noisy = hu + 1024 + rng.standard_normal(hu.shape) * 10 * math.sqrt(factor)
                np.save(os.path.join(path, name), noisy.astype(np.float32))


def write_mayo16_tree(root, n, seed):
    """Mayo-2016 ``test`` pairs (quarter / full dose) at 512^2."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        hu = 1024 + 40 + rng.standard_normal((EVAL_SIZE, EVAL_SIZE)) * 10
        for sub, sigma in (("full_1mm", 0.0), ("quarter_1mm", 20.0)):
            path = os.path.join(root, "Mayo2016_2d", "test", sub)
            os.makedirs(path, exist_ok=True)
            noisy = hu + rng.standard_normal(hu.shape) * sigma
            np.save(os.path.join(path, f"L067-{sub}-{i}.npy"), noisy.astype(np.float32))


def set_bn_stats(tower, run) -> None:
    """Each batch-norm's running statistics of the Dose-CLIP ``tower`` set to
    those of its input in one pass of ``run()`` (without autograd): a trained
    tower's statistics are those of its data."""
    from founddiff_tpu_torch.models.clip import FrozenBatchNorm

    def set_stats(bn, args):
        flat = args[0].reshape(-1, args[0].shape[-1]).double()
        bn.running_mean.copy_(flat.mean(0))
        bn.running_var.copy_(flat.var(0))

    hooks = [m.register_forward_pre_hook(set_stats) for m in tower.modules()
             if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()


def calibrate_tower(tower, slices) -> None:
    """The statistics of :func:`set_bn_stats` over ``slices`` ([N, H, W, 1]
    in [0, 1]) on the FID extractor's path, in one forward.  Left at the
    seeded init, every convolution shrinks the signal, the features hardly
    move between slices and FID reads the eps offset alone."""
    from founddiff_tpu_torch.utils.fid import make_clip_extractor

    set_bn_stats(tower, lambda: make_clip_extractor(tower, batch_size=len(slices))(slices))


FID_FEATURE_RTOL = 1e-3  # card against CPU, relative to the largest |feature|
FID_RTOL = 1e-2  # the card's fid_doseclip against the CPU's FID of the same slices
FID_SPREAD_FLOOR = 1e-2  # median per-dimension std of the NDCT features
EVAL_WORK = os.path.join(REPO, "checkpoints", "chip_smoke_eval")  # phases 16 and 19


def eval_entry(wrappers, plain, card):
    """Phase 16: the evaluation entry point (``python -m founddiff_tpu_torch``,
    in process) at full width on the card, in ``EVAL_WORK``, which it leaves
    for phase 19 and ``main`` removes.  Test mode of ``Config()``
    from a ``model-1.pt`` written by ``Trainer.save`` (weights from seed 16,
    adaLN and prompt perturbed) over the 32 slices of a 512^2 Mayo-2020
    ``test`` tree, with ``eval_counts`` set to the tree; FID; 4 slices on
    the plain path; the no-tower run on Mayo-2016; full-T sampling; train
    mode."""
    import copy
    import shutil

    from founddiff_tpu_torch import cli
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.data import PDFDataset, native
    from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.ops.metrics import compute_psnr, compute_rmse, compute_ssim
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler
    from founddiff_tpu_torch.train.trainer import Trainer
    from founddiff_tpu_torch.utils.fid import fid_from_features, make_clip_extractor

    work = EVAL_WORK
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "mayo")
    t0 = time.perf_counter()
    write_eval_tree(root, "test", None, seed=16)
    write_eval_tree(root, "train512", 2, seed=17)
    write_mayo16_tree(root, EVAL_NO_TOWER, seed=18)
    data_s = time.perf_counter() - t0

    def checkpoint(tower, seed):
        cfg = Config()
        cfg.model.use_dose_encoder = tower
        cfg.train.checkpoint_folder = os.path.join(work, f"seed{seed}")
        diffusion, model = build(cfg, device="cuda", seed=seed, train=True)
        perturb_gates(model, seed=seed)
        if tower:
            ds = PDFDataset("test", root=root)
            slices = np.stack([ds[i][1] for i in range(0, len(ds), len(ds) // 8)])
            calibrate_tower(model.dose_encoder, torch.from_numpy(slices).cuda())
        path = Trainer(diffusion, model, cfg).save(1)
        del diffusion, model
        return path

    def counted(fn, forwards, tag):
        """``fn()`` with the launches of phase 3's PER_FORWARD per UNet forward."""
        wrappers.reset()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = wrappers.counts()
        for k, n in launches.items():
            if n != PER_FORWARD.get(k, 0) * forwards:
                raise AssertionError(f"{tag}: {k} {n} launches in {forwards} UNet forwards, "
                                     f"want {PER_FORWARD.get(k, 0)} per forward")
        return out, seconds, launches

    build_config = cli.build_config

    def with_counts(opt):  # the tree's anatomies and doses; the CLI has no flag
        cfg = build_config(opt)
        cfg.data.eval_counts, cfg.data.eval_doses = EVAL_COUNTS, 4
        return cfg

    n = sum(c for _, c in EVAL_COUNTS) * 4
    cwd = os.getcwd()
    os.chdir(work)
    cli.build_config = with_counts
    try:
        # test mode through the command line, from a reference-layout checkpoint
        path = checkpoint(True, 16)
        tester, cli_s, launches = counted(lambda: cli.main(
            ["--name", "eval", "--data_root", root, "--dataset", "2020_seen",
             "--torch_checkpoint", path, "--device", "cuda"]), n * 2, "eval cli")
        out = os.path.join(work, "checkpoints", "eval", "test_final_npy")
        names = sorted(os.listdir(out))
        if len(names) != n or any(np.load(os.path.join(out, f)).shape != (EVAL_SIZE, EVAL_SIZE)
                                  for f in names):
            raise AssertionError(f"eval cli: {len(names)} predictions, want {n} of 512x512")
        lines = [line.split("] ", 1)[1] for line in open(os.path.join(
            work, "checkpoints", "eval", "test_final.log")).read().splitlines()]
        want = [f"({a} average mean" for a, _ in EVAL_COUNTS]
        want += [f"({a} dose {d:2d}:" for a, _ in EVAL_COUNTS for d in range(4)]
        missing = [w for w in want if not any(line.startswith(w) for line in lines)]
        if missing or not lines[-1].startswith("test_psnr: "):
            raise AssertionError(f"eval cli: log lines missing {missing}: {lines}")
        summary = {k: float(v) for k, v in zip(("psnr", "ssim", "rmse"), re.findall(
            r"-?\d+\.\d+|nan|inf", lines[-1]))}
        if not all(math.isfinite(v) for v in summary.values()):
            raise AssertionError(f"eval cli: summary {summary}")
        # eval slices/s: data, sampling and metrics of the whole set, 2 passes
        passes = []
        native.decodes = 0
        for _ in range(2):
            t = time.perf_counter()
            again = tester.test()
            passes.append(time.perf_counter() - t)
        decoded = native.decodes
        if not all(math.isfinite(again[k]) for k in summary):
            raise AssertionError(f"eval pass: {again}")
        if decoded != 2 * 2 * n:  # an LDCT and an NDCT file a slice, 2 passes
            raise AssertionError(f"eval: the native reader decoded {decoded} of the "
                                 f"{2 * 2 * n} files of the 2 passes")

        # FID on the card, held against the CPU's on the slices it scored
        seen = {}

        def capture(preds, gts):
            seen.update(preds=torch.cat(preds), gts=torch.cat(gts))
            return Trainer._compute_fid(tester, preds, gts)

        tester._compute_fid = capture
        fid = tester.test(fid=True)
        del tester._compute_fid
        tower = tester.ema.dose_encoder
        card_feats = [make_clip_extractor(tower)(seen[k]) for k in ("preds", "gts")]
        cpu_tower = copy.deepcopy(tower).cpu()
        cpu_feats = [make_clip_extractor(cpu_tower)(seen[k].cpu()) for k in ("preds", "gts")]
        del cpu_tower
        feat_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                       for a, b in zip(card_feats, cpu_feats))
        fid_cpu = fid_from_features(*cpu_feats)
        spread = float(np.median(cpu_feats[1].std(axis=0)))
        eps_offset = 2e-6 * cpu_feats[1].shape[1]  # frechet_distance's eps, both sides
        fid_card = fid.get("fid_doseclip", math.nan)
        log(f"[eval fid] {len(seen['preds'])} slices: fid_doseclip {fid_card!r} on the card, "
            f"{fid_cpu!r} on the CPU (bound {FID_RTOL} relative); features card against CPU "
            f"{feat_err:.3e} of the largest (bound {FID_FEATURE_RTOL}); median feature spread "
            f"{spread:.4f} (floor {FID_SPREAD_FLOOR}); eps offset {eps_offset:.4f}")
        if not (len(seen["preds"]) == n and feat_err <= FID_FEATURE_RTOL
                and abs(fid_card - fid_cpu) <= FID_RTOL * abs(fid_cpu)
                and spread >= FID_SPREAD_FLOOR and fid_card > 100 * eps_offset):
            raise AssertionError(f"eval fid: card {fid_card!r}, CPU {fid_cpu!r}, features "
                                 f"{feat_err:.3e}, spread {spread:.4f}, {len(seen['preds'])} "
                                 f"slices")

        # 4 slices on the kernel path and on the plain path; metrics card vs CPU
        gen = torch.Generator().manual_seed(16)
        items = [tester.sample_dataset[i] for i in range(4)]
        noises = [torch.randn(1, EVAL_SIZE, EVAL_SIZE, 1, generator=gen) for _ in items]

        def four():
            return [tester.sample(torch.from_numpy(ld[None]).cuda(), noise=z,
                                  use_test_schedule=True) for (_, ld), z in zip(items, noises)]

        kernel_preds = four()
        wrappers.reset()
        with swapped(plain):
            plain_preds = four()
        launched = wrappers.used()
        if launched:
            raise AssertionError(f"eval plain: the plain path launched kernels {launched}")
        gates = [psnr(a, b) for a, b in zip(kernel_preds, plain_preds)]
        metric_err = 0.0
        for pred, (gt, _) in zip(kernel_preds, items):
            gt = torch.from_numpy(gt[None]).cuda()
            fns = (compute_psnr, compute_ssim, compute_rmse)
            on_card = torch.stack([f(pred, gt) for f in fns]).cpu()
            on_cpu = torch.stack([f(pred.cpu(), gt.cpu()) for f in fns])
            metric_err = max(metric_err, float((on_card - on_cpu).abs().max()))
        log(f"[eval gate] 4 slices, test schedule, fp32, kernel vs plain path: PSNR "
            f"{[round(g, 2) for g in gates]} dB (gate {PSNR_GATE_DB}); PSNR/SSIM/RMSE on the "
            f"card against the CPU: max |diff| {metric_err:.3e} (bound 1e-4)")
        if min(gates) < PSNR_GATE_DB:
            raise AssertionError(f"eval numerics gate failed: {gates}")
        if not metric_err <= 1e-4:
            raise AssertionError(f"eval metrics: card against CPU {metric_err:.3e}")

        # full-T: p_sample_loop through the hoisted sampler, one slice
        d = tester.diffusion
        full = ResidualDiffusion(None, image_size=EVAL_SIZE, timesteps=EVAL_FULL_T,
                                 sampling_timesteps=EVAL_FULL_T, objective=d.objective,
                                 loss_type=d.loss_type, condition=True, sum_scale=d.sum_scale,
                                 test_res_or_noise=d.test_res_or_noise, device="cuda")
        sampler = make_hoisted_sampler(tester.ema, full)
        x = torch.from_numpy(items[0][1][None]).cuda()
        full_out, full_s, full_launches = counted(
            lambda: sampler(x, generator=torch.Generator().manual_seed(50)), EVAL_FULL_T,
            "eval full-T")
        if full_out.shape != x.shape or not bool(torch.isfinite(full_out).all()):
            raise AssertionError(f"eval full-T: bad output {tuple(full_out.shape)}")
        del tester, sampler
        torch.cuda.empty_cache()

        # test mode without the tower: ResidualDiffusion.sample on Mayo-2016
        path = checkpoint(False, 17)
        plain_tester, no_tower_s, no_tower_launches = counted(lambda: cli.main(
            ["--name", "notower", "--no_dose_encoder", "--data_root", root, "--dataset",
             "2016_unseen", "--torch_checkpoint", path, "--device", "cuda"]),
            EVAL_NO_TOWER * 2, "eval no tower")
        out = os.path.join(work, "checkpoints", "notower", "test_final_2016_npy")
        if len(os.listdir(out)) != EVAL_NO_TOWER:
            raise AssertionError(f"eval no tower: {len(os.listdir(out))} predictions")
        del plain_tester
        torch.cuda.empty_cache()

        # train mode: 4 steps of 1 x 2 slices at 512^2, previews every 2 steps
        t = time.perf_counter()
        trainer = cli.main(["--name", "train", "--is_train", "--debug", "--train_num_steps", "4",
                            "--train_batch_size", "1", "--data_root", root, "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        folder = os.path.join(work, "checkpoints", "train")
        files = set(os.listdir(folder)) | set(os.listdir(os.path.join(folder, "sample")))
        need = [("train.log",), ("metrics.jsonl",), ("sample-1.png", "sample-1.png.npy"),
                ("sample-2.png", "sample-2.png.npy")]
        if trainer.step != 4 or not all(any(f in files for f in alts) for alts in need):
            raise AssertionError(f"eval train mode: step {trainer.step}, files {sorted(files)}")
        del trainer
        torch.cuda.empty_cache()
    finally:
        cli.build_config = build_config
        os.chdir(cwd)

    reader = native.reader()
    slices_per_s = n / statistics.median(passes)
    log(f"[eval] Config() {EVAL_SIZE}^2 DDIM-2 fp32, {n} slices: {slices_per_s:.3f} eval "
        f"slices/s (data, sampling and metrics; passes {[round(p, 3) for p in passes]} s), "
        f"reader {reader}; cli test mode {cli_s:.2f} s (build, load, test, save), launches "
        f"{launches}; summary {summary}; fid_doseclip {fid_card:.4f}; no tower "
        f"{EVAL_NO_TOWER} slices {no_tower_s:.2f} s; full-T {EVAL_FULL_T} steps {full_s:.2f} s, "
        f"launches {full_launches}; train mode 4 steps {train_s:.2f} s; tree {data_s:.2f} s "
        f"[{card}]")
    return dict(slices=n, eval_slices_per_s=slices_per_s, pass_s=passes, reader=reader,
                native_decodes=decoded, cli_s=cli_s, launches=launches, summary=summary,
                fid_doseclip=fid_card, fid_cpu=fid_cpu, fid_feature_err=feat_err,
                fid_feature_spread=spread,
                gate_psnr_db=gates, metric_card_cpu_max_abs=metric_err, no_tower_s=no_tower_s,
                no_tower_launches=no_tower_launches, full_t_s=full_s,
                full_t_launches=full_launches, train_mode_s=train_s, tree_s=data_s,
                work=work)



# phase 17: the scan operands of the 512^2 first level (B 1, K 4, L 256^2,
# D 128, N 4, fp32), split into virtual shards; a world of one over NCCL
SEQ_OPERANDS = (1, 4, 256 * 256, 128, 4)
SEQ_SHARDS = (2, 4)
SEQ_RTOL, SEQ_ATOL = 2e-4, 2e-5
VOLUME_Z, VOLUME_BPD = 18, 4  # 18 slices in waves of 4: 2 of padding
GRAD_EXACT_RTOL = 1e-6  # DP step against the step without a mesh, per parameter


def seq_virtual_shards(wrappers, card):
    """Phase 17 (a): the sequence-sharded composition on the card in one
    process, ``local_summary`` per virtual shard (the kernel with its last
    state) and ``apply_prefix`` per shard over the stacked summaries, at 2
    and 4 shards of the 512^2 first level's scan operands; held against the
    unsharded kernel scan and the plain chunked scan (rtol 2e-4 / atol
    2e-5).  Times the correction of the last shard (the longest fold) and
    its peak memory above the operands."""
    from founddiff_tpu_torch.ops.scan import scan_forward
    from founddiff_tpu_torch.ops.selective_scan import selective_scan_chunked
    from founddiff_tpu_torch.parallel import apply_prefix, local_summary

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(170)
    B, K, L, D, N = SEQ_OPERANDS
    R = -(-(D // 2) // 16)  # dt_rank of the C0 64 block
    u = torch.nn.functional.silu(_n(gen, (B, K, L, D), 1.0, dev))
    delta = _n(gen, (B, K, L, D), R ** -0.5, dev)
    Bm, Cm = (_n(gen, (B, K, L, N), 0.5, dev) for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(K, D, N).contiguous().to(dev)
    Ds, bias = torch.ones(K, D, device=dev), _dt_bias(gen, K, D, dev)
    y_kernel = scan_forward(u, delta, A, Bm, Cm, Ds, bias)[0]
    y_plain = selective_scan_chunked(u, delta, A, Bm, Cm, Ds, bias)
    out = {}
    for n in SEQ_SHARDS:
        Ll = L // n
        part = lambda t, i: t[:, :, i * Ll:(i + 1) * Ll]
        torch.cuda.synchronize()
        wrappers.reset()
        shards = [local_summary(part(u, i), part(delta, i), A, part(Bm, i), part(Cm, i), Ds,
                                bias) for i in range(n)]
        launches = wrappers.counts()["scan_forward"]
        all_Ap = torch.stack([sh[1] for sh in shards])
        all_he = torch.stack([sh[2] for sh in shards])
        last = shards[-1]
        correct = lambda: apply_prefix(last[0], last[3], part(Cm, n - 1), A, all_Ap, all_he,
                                       n - 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        correct()
        torch.cuda.synchronize()
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = cuda_ms(correct, reps=5, warm=1)
        got = torch.cat([apply_prefix(sh[0], sh[3], part(Cm, i), A, all_Ap, all_he, i)
                         for i, sh in enumerate(shards)], dim=2)
        torch.cuda.synchronize()
        row = dict(shards=n, scan_forward_launches=launches, correction_ms=ms,
                   correction_peak_gib=peak_gib)
        for tag, want in (("kernel", y_kernel), ("plain", y_plain)):
            diff = (got - want).abs()
            row[f"max_abs_err_{tag}"] = float(diff.max())
            row[f"ok_{tag}"] = bool((diff <= SEQ_ATOL + SEQ_RTOL * want.abs()).all())
        out[n] = row
        log(f"[seq] {n} virtual shards of L {L} (B {B} K {K} D {D} N {N}, fp32): against the "
            f"unsharded kernel scan max |diff| {row['max_abs_err_kernel']:.3e}, against the "
            f"plain scan {row['max_abs_err_plain']:.3e} (rtol {SEQ_RTOL}, atol {SEQ_ATOL}); "
            f"{launches} scan_forward launches (last state); the correction of shard {n - 1} "
            f"{ms:.3f} ms, peak {peak_gib:.3f} GiB [{card}]")
        if launches != n or not (row["ok_kernel"] and row["ok_plain"]):
            raise AssertionError(f"sequence-sharded composition at {n} shards: {row}")
        del shards, all_Ap, all_he, last, got
    return out


def last_state_summary(record):
    """``scan_forward``'s last-state mode for the kernels line: phase 2's
    cases and worst h_last error, and its launches on the seq route
    (phase 17's virtual shards)."""
    rows = record["last_state"]
    return dict(cases=len(rows), bit_identical=all(r["bit_identical"] for r in rows),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                seq_route_launches={n: r["scan_forward_launches"]
                                    for n, r in record["seq_shards"].items()})


def distributed(wrappers, plain, card, model, diffusion, train):
    """Phase 17 (b, c): ``init_distributed`` at world size 1 over NCCL (a
    ``FileStore`` rendezvous), ``make_mesh()``; one data-parallel fp32 train
    step of ``Config()`` at 512^2 against a step without a mesh on the same
    batch and draws (gradients per parameter), two more timed beside phase
    7's with their launches; ``make_volume_denoiser`` of phase 3's model on
    a seeded volume of 18 slices in bf16 waves of 4 (slices/s, every wave
    bit-identical to the hoisted sampler's on the same noise, the plain-path
    gate on one slice); then ``python -m founddiff_tpu_torch.tools.
    denoise_volume`` once as a subprocess on a saved ``model-1.pt``."""
    import shutil

    import torch.distributed as dist

    from founddiff_tpu_torch.parallel import init_distributed, make_mesh

    work = os.path.join(REPO, "checkpoints", "chip_smoke_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    store = dist.FileStore(os.path.join(work, "store"), 1)
    device = init_distributed("cuda", rank=0, world_size=1, store=store)
    out = dict(backend=dist.get_backend(), device=str(device))
    try:
        mesh = make_mesh()
        out["mesh"] = mesh.shape
        if out["backend"] != "nccl" or mesh.groups["data"] is None:
            raise AssertionError(f"distributed: {out}, groups {mesh.groups}")
        out["train"] = _dp_step(wrappers, card, mesh, work, train)
        out["volume"] = _volume(wrappers, plain, card, model, diffusion, mesh)
    finally:
        dist.destroy_process_group()
    out["tool"] = _volume_tool(card, model, work)
    shutil.rmtree(work, ignore_errors=True)
    return out


def _dp_step(wrappers, card, mesh, work, train):
    import torch.distributed as dist

    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.train.checkpoint_folder = os.path.join(work, "train")
    B = cfg.train.train_batch_size * cfg.train.gradient_accumulate_every
    S = cfg.diffusion.image_size
    gen = torch.Generator().manual_seed(17)

    def batch():
        gt = torch.rand((B, S, S, 1), generator=gen)
        return gt, (gt + 0.1 * torch.randn((B, S, S, 1), generator=gen)).clamp(0, 1)

    def trainer(m):
        d, net = build(cfg, device="cuda", seed=0, train=True)
        perturb_gates(net, seed=0)
        return Trainer(d, net, cfg, mesh=m)

    # the compared steps with cuDNN's deterministic algorithms (its default
    # weight-gradient algorithms may sum in another order from run to run);
    # the timed steps with the defaults, as phase 7's
    first = batch()
    ref = trainer(None)
    torch.backends.cudnn.deterministic = True
    loss_ref = ref.train_step(first)
    want = {n: p.grad.detach().clone() for n, p in ref.model.named_parameters()
            if p.grad is not None}
    del ref
    torch.cuda.empty_cache()
    dp = trainer(mesh)
    counts, times, losses = {}, [], []
    for b in (first, batch(), batch()):
        torch.cuda.synchronize()
        wrappers.reset()
        t0 = time.perf_counter()
        losses.append(dp.train_step(b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for k, n in wrappers.counts().items():
            counts.setdefault(k, []).append(n)
        if len(times) == 1:
            got = {n: p.grad.detach().clone() for n, p in dp.model.named_parameters()
                   if p.grad is not None}
            torch.backends.cudnn.deterministic = False
    if got.keys() != want.keys():
        raise AssertionError("DP step: another set of parameters has gradients")
    same = sum(torch.equal(got[n], want[n]) for n in want)
    worst = max(float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30))
                for n in want)
    for k in wrappers:
        if any(c != PER_STEP.get(k, 0) for c in counts[k]):
            raise AssertionError(f"DP step: {k} launches per step {counts[k]}, want "
                                 f"{PER_STEP.get(k, 0)}")
    step_s = statistics.median(times[1:])
    log(f"[dist train] DP fp32 step of Config() {S}^2 at mesh {mesh.shape} "
        f"({dist.get_backend()}, world {dist.get_world_size()}): "
        f"loss {losses[0][0]:.6f} against {loss_ref[0]:.6f} without a mesh; gradients "
        f"bit-identical in {same} of {len(want)} parameters, worst relative "
        f"{worst:.3e} (limit {GRAD_EXACT_RTOL}); steps {[round(t, 4) for t in times]} s, "
        f"timed {step_s:.4f} s against phase 7's {statistics.median(train['step_s']):.4f} s; "
        f"launches per step {dict((k, v[0]) for k, v in counts.items() if v[0])} [{card}]")
    if worst > GRAD_EXACT_RTOL or any(abs(a - b) > GRAD_EXACT_RTOL * abs(b)
                                      for a, b in zip(losses[0], loss_ref)):
        raise AssertionError(f"DP step against the step without a mesh: worst {worst:.3e}, "
                             f"losses {losses[0]} / {loss_ref}")
    return dict(loss=losses[0], loss_no_mesh=loss_ref, grads_bit_identical=same,
                grads=len(want), worst_grad_rel=worst, step_s=times, timed_step_s=step_s,
                phase7_step_s=statistics.median(train["step_s"]),
                launches={k: v[0] for k, v in counts.items()})


def _volume(wrappers, plain, card, model, diffusion, mesh):
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler, make_volume_denoiser

    bf16 = torch.bfloat16
    S = diffusion.image_size
    vol = torch.from_numpy(np.random.default_rng(17).random((VOLUME_Z, S, S, 1),
                                                            dtype=np.float32)).cuda()
    denoise = make_volume_denoiser(model, diffusion, mesh, batch_per_device=VOLUME_BPD,
                                   compute_dtype=bf16)
    denoise(vol[:VOLUME_BPD], generator=torch.Generator().manual_seed(1))  # warm-up
    torch.cuda.synchronize()
    wrappers.reset()
    t0 = time.perf_counter()
    got = denoise(vol, generator=torch.Generator().manual_seed(18))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    waves = -(-VOLUME_Z // VOLUME_BPD)
    forwards = waves * diffusion.sampling_timesteps
    launches = wrappers.counts()
    for k, n in launches.items():
        if n != PER_FORWARD.get(k, 0) * forwards:
            raise AssertionError(f"volume: {k} {n} launches in {forwards} UNet forwards")
    # the hoisted sampler's waves on the same draws
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=bf16)
    gen = torch.Generator().manual_seed(18)
    padded = torch.cat([vol, vol[-1:].expand(waves * VOLUME_BPD - VOLUME_Z, S, S, 1)])
    same = []
    for w in range(waves):
        x = padded[w * VOLUME_BPD:(w + 1) * VOLUME_BPD]
        want = sampler(x, generator=gen, noise=torch.randn(tuple(x.shape), generator=gen))
        n = min(VOLUME_BPD, VOLUME_Z - w * VOLUME_BPD)
        same.append(torch.equal(got[w * VOLUME_BPD:w * VOLUME_BPD + n], want[:n]))
    ok = got.shape == (VOLUME_Z, S, S, 1) and bool(torch.isfinite(got).all())
    one = make_volume_denoiser(model, diffusion, mesh, batch_per_device=1, compute_dtype=bf16)
    gate = plain_gate(lambda x, seed: one(x, generator=torch.Generator().manual_seed(seed)),
                      vol[:1], plain, wrappers, "volume", diffusion.sampling_timesteps)
    log(f"[dist volume] {VOLUME_Z} slices of {S}^2 bf16 in waves of {VOLUME_BPD} at mesh "
        f"{mesh.shape}: {dt:.3f} s, {VOLUME_Z / dt:.3f} slices/s (phase 3 bs4: see [main]); "
        f"waves bit-identical to the hoisted sampler's: {same}; launches {launches} over "
        f"{forwards} UNet forwards [{card}]")
    if not (ok and all(same)):
        raise AssertionError(f"volume denoiser: shape/finite {ok}, waves identical {same}")
    return dict(seconds=dt, slices_per_s=VOLUME_Z / dt, waves_bit_identical=same,
                launches=launches, forwards=forwards, gate=gate)


def _volume_tool(card, model, work):
    """``python -m founddiff_tpu_torch.tools.denoise_volume`` on a 4-slice
    volume and a ``model-1.pt`` of phase 3's weights (the reference layout,
    online weights alone), as a user runs it."""
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, "model-1.pt")
    torch.save({"model": {f"model.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    src, dst = os.path.join(work, "volume.npy"), os.path.join(work, "denoised.npy")
    np.save(src, np.random.default_rng(19).random((4, 512, 512), dtype=np.float32))
    cmd = [sys.executable, "-m", "founddiff_tpu_torch.tools.denoise_volume", src, dst,
           "--checkpoint", ckpt, "--batch_per_device", "2", "--bf16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    dt = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    shape = tuple(np.load(dst).shape) if proc.returncode == 0 else None
    log(f"[dist tool] {' '.join(cmd[1:4])} ...: rc {proc.returncode} in {dt:.1f} s, output "
        f"{shape}: {summary} [{card}]")
    if proc.returncode != 0 or shape != (4, 512, 512) or \
            not summary.startswith("denoised 4 slices @ 512^2"):
        raise AssertionError(f"denoise_volume: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return dict(rc=proc.returncode, seconds=dt, shape=shape, summary=summary)

def beside_parent(tag, train, card) -> None:
    """The fp32 step of ``train_full_width`` beside the parent tree's."""
    log(f"[{tag}] fp32 step {statistics.median(train['step_s']):.4f} s; the parent tree's "
        f"{' / '.join(f'{t:.4f}' for t in PARENT_STEP_S[train['size']])} s "
        f"(scripts/port_ab.py, two turns) [{card}]")


# --- phase 18: the model options ------------------------------------------------


def _rel(got, want, base=None) -> float:
    """||got - want|| / ||want - base||, fp32."""
    ref = want.float() if base is None else want.float() - base.float()
    return float((got.float() - want.float()).norm() / ref.norm().clamp_min(1e-30))


def silu_serving(request, x_all, wrappers, plain, steps, outs, main, card):
    """Phase 18 (a): phase 3's requests under ``FOUNDDIFF_SILU=kernel``: every
    ``ss2d_image_block`` launch with its silu flag, the outputs against phase
    3's (the same weights and seeds; PSNR >= 40 dB, the count of elements
    that differ printed) and against the plain path, slices/s beside phase
    3's."""
    with routes_on(FOUNDDIFF_SILU="kernel"):
        rec, outs_silu = serve_requests(request, x_all, wrappers, PER_FORWARD, steps, "silu")
        rec["gate"] = plain_gate(request, x_all[:1], plain, wrappers, "silu", steps)
    want = PER_FORWARD["ss2d_image_block"] * rec["forwards"]
    if rec["launches_silu"] != want:
        raise AssertionError(f"silu: {rec['launches_silu']} ss2d_image_block launches with "
                             f"silu_input, want {want}")
    if main["launches_silu"] != 0:
        raise AssertionError("phase 3 (the variable unset) launched the silu flag")
    rec["psnr_db"] = [psnr(a, b) for a, b in zip(outs_silu, outs)]
    rec["differing"] = [int((a != b).sum()) for a, b in zip(outs_silu, outs)]
    rec["elements"] = [a.numel() for a in outs]
    worst = min(rec["psnr_db"])
    log(f"[silu] DDIM-{steps} 512^2 bf16 with FOUNDDIFF_SILU=kernel: bs1 "
        f"{rec['bs1_slices_per_s']:.3f} slices/s (request s "
        f"{[round(t, 4) for t in rec['bs1_request_s']]}), bs4 {rec['bs4_slices_per_s']:.3f} "
        f"slices/s (batch s {[round(t, 4) for t in rec['bs4_batch_s']]}); phase 3: bs1 "
        f"{main['bs1_slices_per_s']:.3f}, bs4 {main['bs4_slices_per_s']:.3f} slices/s [{card}]")
    log(f"[silu gate] the 6 requests against phase 3's: PSNR "
        f"{[round(p, 2) for p in rec['psnr_db']]} dB (gate {PSNR_GATE_DB}), differing elements "
        f"{rec['differing']} of {rec['elements']}")
    if not worst >= PSNR_GATE_DB:
        raise AssertionError(f"silu against phase 3: {worst:.2f} dB")
    return rec


def aux_on_card(card):
    """Phase 18 (c): the two auxiliary terms at 512^2 (4 slices, NHWC, as
    ``p_losses`` forms them) on the card against the CPU, relative AUX_RTOL."""
    from founddiff_tpu_torch.ops.losses import grad_loss, wt_decomp

    gen = torch.Generator().manual_seed(18)
    pred = torch.randn((4, 512, 512, 1), generator=gen) * 0.3
    target = pred + 0.1 * torch.randn((4, 512, 512, 1), generator=gen)

    def terms(p, t):
        hi = lambda v: wt_decomp(v.movedim(-1, 1), level=3)[1]
        return grad_loss(p, t), (hi(p) - hi(t)).abs().mean()

    cpu = terms(pred, target)
    t0 = time.perf_counter()
    gpu = terms(pred.cuda(), target.cuda())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rel = [abs(float(g) - float(c)) / abs(float(c)) for g, c in zip(gpu, cpu)]
    log(f"[aux] grad_loss {float(gpu[0]):.6e} (CPU {float(cpu[0]):.6e}), wavelet level-3 "
        f"{float(gpu[1]):.6e} (CPU {float(cpu[1]):.6e}) at 4 x 512^2: relative "
        f"{[f'{r:.2e}' for r in rel]} (gate {AUX_RTOL}); {ms:.1f} ms on the card [{card}]")
    if not all(r <= AUX_RTOL for r in rel):
        raise AssertionError(f"auxiliary losses on the card against the CPU: {rel}")
    return dict(card=[float(v) for v in gpu], cpu=[float(v) for v in cpu], rel=rel, ms=ms)


def no_tower_options(wrappers, card):
    """Phase 18 (d): a no-tower ``UnetRes`` of ``Config()`` at 512^2 with
    ``learned_variance``, ``input_condition`` and ``input_condition_mask``:
    one Adam step on (gt, ld, mask) pairs (the loss broadcasts the two
    output channels, as in JAX); its DDIM-2 sample raises TypeError, as the
    JAX scan does; the same build without ``learned_variance`` samples
    DDIM-2 (finite, [0, 1], phase 3's launches per UNet forward)."""
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build

    gen = torch.Generator().manual_seed(19)
    gt = torch.rand((2, 512, 512, 1), generator=gen).cuda()
    ld = (gt + 0.05 * torch.randn(gt.shape, generator=gen).cuda()).clamp(0, 1)
    mask = (torch.rand(gt.shape, generator=gen) > 0.5).float().cuda()
    result = {}
    for lv in (True, False):
        cfg = Config()
        m = cfg.model
        m.use_dose_encoder, m.learned_variance = False, lv
        m.input_condition, m.input_condition_mask = True, True
        diffusion, model = build(cfg, device="cuda", seed=0, train=lv)
        perturb_gates(model, seed=0)
        if lv:
            opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=2e-4)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            wrappers.reset()
            t0 = time.perf_counter()
            loss = sum(diffusion.loss([gt, ld, mask], generator=torch.Generator().manual_seed(1)))
            loss.backward()
            grads = [p.grad for p in model.parameters() if p.requires_grad]
            live = sum(g is not None and bool(g.abs().max() > 0) for g in grads)
            finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
            opt.step()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches = wrappers.used()
            moved = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
            out_ch = model.unet0.final_conv.weight.shape[0]
            # the dose-prompt weights see zero embeddings without the tower: no gradient
            if not (math.isfinite(float(loss)) and finite and moved == live
                    and live > 0.9 * len(grads) and out_ch == 2):
                raise AssertionError(f"no-tower step: loss {float(loss)}, finite {finite}, "
                                     f"{moved} parameters moved, {live} of {len(grads)} with a "
                                     f"gradient, {out_ch} channels")
            model.eval()
            try:
                with torch.no_grad():
                    diffusion.sample([ld, mask], use_test_schedule=True)
                raise AssertionError("a learned_variance sample did not raise")
            except TypeError as e:
                refused = str(e)
            result["step"] = dict(loss=float(loss), step_s=step_s, launches=launches,
                                  refused=refused)
            log(f"[no tower] UnetRes 512^2 learned_variance + input_condition + mask: loss "
                f"{float(loss):.6f}, {moved} of {len(grads)} parameters moved (those with a "
                f"non-zero gradient), step {step_s:.3f} s, launches "
                f"{launches}; its DDIM-2 sample raises TypeError as the JAX scan does ({refused})"
                f" [{card}]")
        else:
            wrappers.reset()
            with torch.no_grad():
                out = diffusion.sample([ld, mask], use_test_schedule=True,
                                       generator=torch.Generator().manual_seed(2))
            torch.cuda.synchronize()
            launches = wrappers.used()
            img = out[-1]
            ok = (img.shape == ld.shape and bool(torch.isfinite(img).all())
                  and 0.0 <= float(img.min()) and float(img.max()) <= 1.0)
            per = {k: PER_FORWARD.get(k, 0) * 2 for k in wrappers}  # two UNet forwards
            if not ok or any(launches.get(k, 0) != n for k, n in per.items()):
                raise AssertionError(f"no-tower DDIM-2 sample: {tuple(img.shape)}, launches "
                                     f"{launches}, want {per}")
            result["sample"] = dict(launches=launches, shape=list(img.shape))
            log(f"[no tower] UnetRes 512^2 input_condition + mask, DDIM-2 bs2: "
                f"{tuple(img.shape)} in [0, 1], launches {launches}")
        del model, diffusion
        torch.cuda.empty_cache()
    return result


def _variant_io(gen, dev, H, C0):
    x = _n(gen, (1, H, H, C0), 1.0, dev)
    c = _n(gen, (1, 1, 256), 0.1, dev)
    gate = _n(gen, (1, C0), 0.3, dev)
    return x, c, gate


def ss2d_variants(wrappers, plain, card):
    """Phase 18 (e): each SS2D variant at the first level of ``Config()`` (C0
    64 on 512^2, d_state 4), bs1 fp32, seeded weights (non-zero biases),
    through the kernel path and the plain path: ``use_bias`` and ``dropout``
    (eval) on the image scan and the epilogue without the fold, then out_proj
    and the gated residual; ``conv_bias=False``, ``d_conv`` 5, ``dt_rank`` 8
    on the fused block; v0 on the fused-projection scan of its four full
    sequences; step 3 on the fused-projection scan of its sequences (the
    merge raises, as in JAX); then ``MambaBlock(cross=True)`` and
    ``PatchMerging2D`` at C0 512 on 64^2 (the latter plain PyTorch, card
    against CPU), and a self-attending ``CrossAttention`` at L 4,096 on the
    flash kernel.  Each: ||kernel - plain|| / ||plain - residual|| <=
    VARIANT_RTOL, and the launches of its sites."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.blocks import CrossAttention
    from founddiff_tpu_torch.models.ss2d import SS2D, MambaBlock, PatchMerging2D

    dev = torch.device("cuda")
    H, C0, N = VARIANT
    variants = {"use_bias": (dict(use_bias=True), SITES[1:3]),
                "dropout": (dict(dropout=0.1), SITES[1:3]),
                "conv": (dict(conv_bias=False, d_conv=5, dt_rank=8), ("ss2d_image_block",)),
                "v0": (dict(forward_type="v0"), SITES[3:4]),
                "step 3": (dict(step_size=3), SITES[4:5])}
    result, failed, sites = {}, [], {}

    def run(fn):
        wrappers.reset()
        with torch.no_grad():
            got = fn()
        torch.cuda.synchronize()
        used = wrappers.used()
        wrappers.reset()
        with torch.no_grad(), swapped(plain):
            want = fn()
        launched = wrappers.used()
        if launched:
            raise AssertionError(f"the plain path launched kernels {launched}")
        return got, want, used

    for name, (opts, site_keys) in variants.items():
        gen = torch.Generator().manual_seed(len(name))
        mod = SS2D(C0, N, **opts)
        init_params(mod, gen)
        mod = mod.to(dev).eval().requires_grad_(False)
        x, c, gate = _variant_io(gen, dev, H, C0)
        if name == "step 3":
            xs = torch.nn.functional.silu(_n(gen, (1, H, H, 2 * C0), 1.0, dev))
            got, want, used = run(lambda: mod.scan_core(xs, merge=False))
            try:
                mod(x, c, gate, x)
                raise AssertionError("step 3: the merge did not raise")
            except TypeError:
                pass
            base = None
        else:
            got, want, used = run(lambda: mod(x, c, gate, x))
            base = x
        rel = _rel(got, want, base)
        for k in site_keys:
            if k in SITE_WRAPPER:
                sites[k] = used.get(SITE_WRAPPER[k], 0)
        result[name] = dict(rel=rel, launches=used, shape=list(got.shape))
        log(f"[variants] SS2D {name} {opts} at {H}^2 C0={C0} N={N} fp32: kernel against plain "
            f"path {rel:.3e} (gate {VARIANT_RTOL}), launches {used}")
        if not rel <= VARIANT_RTOL:
            failed.append(name)
        del mod
    # MambaBlock(cross) and PatchMerging2D at C0 512 on 64^2
    gen = torch.Generator().manual_seed(512)
    block = MambaBlock(512, 32, time_dim=256, cross=True)
    init_params(block, gen)
    with torch.no_grad():
        for p in (block.adaLN_modulation[1].weight, block.adaLN_modulation[1].bias):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    block = block.to(dev).eval().requires_grad_(False)
    x, c, _ = _variant_io(gen, dev, 64, 512)
    t = _n(gen, (1, 256), 1.0, dev)
    got, want, used = run(lambda: block(x, c, t))
    result["cross"] = dict(rel=_rel(got, want, x), launches=used)
    if "attn_block" in used or not result["cross"]["rel"] <= VARIANT_RTOL:
        failed.append("cross")
    log(f"[variants] MambaBlock(cross=True) 64^2 C=512 N=32 fp32: kernel against plain path "
        f"{result['cross']['rel']:.3e}, launches {used}")
    pm = PatchMerging2D(512)
    init_params(pm, gen)
    pm.requires_grad_(False)
    y_cpu = pm(x.cpu())
    y_card = pm.to(dev)(x)
    result["patch_merging"] = dict(rel=_rel(y_card.cpu(), y_cpu), shape=list(y_card.shape))
    if not result["patch_merging"]["rel"] <= VARIANT_RTOL:
        failed.append("patch_merging")
    log(f"[variants] PatchMerging2D 64^2 C=512 -> {tuple(y_card.shape)}: card against CPU "
        f"{result['patch_merging']['rel']:.3e}")
    attn = CrossAttention(512, context_dim=512)
    init_params(attn, gen)
    attn = attn.to(dev).eval().requires_grad_(False)
    got, want, used = run(lambda: attn(x))
    sites[SITES[5]] = used.get("flash_fwd", 0)
    result["cross_self"] = dict(rel=_rel(got, want), launches=used)
    if used.get("flash_fwd") != 1 or not result["cross_self"]["rel"] <= VARIANT_RTOL:
        failed.append("cross_self")
    log(f"[variants] CrossAttention self 64^2 C=512 (L 4096) fp32: kernel against plain path "
        f"{result['cross_self']['rel']:.3e}, launches {used} [{card}]")
    if failed:
        raise AssertionError(f"SS2D variants: kernel path against plain path: {failed}")
    result["sites"] = sites
    return result


def options(request, x_all, outs, wrappers, plain_default, plain_all, steps, record, card):
    """Phase 18: the model and loss options (the docstring's item 18)."""
    from founddiff_tpu_torch.config import Config

    t18 = time.perf_counter()
    out = {"serving": silu_serving(request, x_all, wrappers, plain_default, steps, outs,
                                   record["main"], card)}
    with routes_on(FOUNDDIFF_SILU="kernel"):
        out["train"] = train_full_width(wrappers, card, Config(), PER_STEP, "train silu",
                                        full=False)
        out["train_aux"] = train_full_width(wrappers, card, Config(), PER_STEP, "train aux",
                                            full=False, aux=AUX)
        out["autograd"] = check_autograd(plain_default, wrappers, "autograd silu")
    for tag in ("train", "train_aux"):
        silu = out[tag]["per_step"]["ss2d_image_block silu_input"]
        if any(n != PER_STEP["ss2d_image_block"] for n in silu):
            raise AssertionError(f"{tag} silu: silu_input launches per step {silu}")
    log(f"[train silu] fp32 step {statistics.median(out['train']['step_s']):.4f} s with "
        f"FOUNDDIFF_SILU=kernel, {statistics.median(out['train_aux']['step_s']):.4f} s with "
        f"the auxiliary weights {AUX} too; phase 7: "
        f"{statistics.median(record['train']['step_s']):.4f} s [{card}]")
    out["aux"] = aux_on_card(card)
    torch.cuda.empty_cache()
    out["no_tower"] = no_tower_options(wrappers, card)
    out["variants"] = ss2d_variants(wrappers, plain_all, card)
    out["seconds"] = time.perf_counter() - t18
    log(f"[phase 18] {out['seconds']:.1f} s")
    return out


# --- phase 19: the Dose-CLIP family and the tools ------------------------------

DOSECLIP_STEPS, DOSECLIP_BATCH, DOSECLIP_CHECK_BATCH = 6, 8, 2
CLIP_RTOL = 1e-4  # the CLIP family and the Dose-CLIP step, card against CPU, relative
IQA_RTOL = 1e-5  # LPIPS and clip_preprocess, card against CPU, relative
FID_TOOL_RTOL = 1e-3  # the FID tool's fid_doseclip against compute_fid in process
REPORT_ATOL = 1e-5  # analyze_results' 4-decimal means against the same rounding in process
FIXTURE_BPE = os.path.join(REPO, "tests", "fixtures", "bpe_tiny_vocab.txt.gz")
# stock-layout shapes: OpenAI ViT-B/32 and RN50
VIT_B32 = dict(embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
               vision_patch_size=32, context_length=77, vocab_size=49408, transformer_width=512,
               transformer_heads=8, transformer_layers=12)
RN50 = dict(VIT_B32, embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64)
FID_KEYS = {"fid_doseclip", "feature_extractor", "n_generated", "n_reference"}
# the port's kernels of an fp32 train step of Config() by their CUDA symbols,
# grouped as the units that launch them (first match wins): the layer-norm
# statistics kernel runs in layer_norm_modulated and inside the other two
# serving kernels, so it is a group of its own
TRACE_UNITS = (
    ("attn_block", ("attn_block",), ("qkv_kernel", "gram_reduce_kernel", "fold_kernel",
                                     "EpiGated")),
    ("the scans", ("scan_forward", "scan_backward", "scan_image_forward"),
     ("fwd_kernel", "bwd_local_kernel", "bwd_main_kernel", "reduce_bc_kernel",
      "reduce_params_kernel", "carry_scan_kernel", "chunk_pass_kernel", "EpiProjFast")),
    ("ss2d_image_block", ("ss2d_image_block",), ("image_scan_chunk_kernel",
                                                 "image_scan_carry_kernel", "gemm_kernel")),
    ("layer norms", ("layer_norm_modulated",), ("ln_rows_vec_kernel",)),
)


def _rel_err(card, cpu) -> float:
    card, cpu = card.detach().float().cpu(), cpu.detach().float()
    return float((card - cpu).norm() / cpu.norm())


def _run_tool(module, *args, tag, tf32_off=True):
    """``python -m founddiff_tpu_torch.tools.<module>`` from the repository
    root; returns the completed process.  ``tf32_off``: TF32 off in cuBLAS
    and cuDNN as in this process (phase 1), for a tool whose numbers are
    compared here (PyTorch's defaults let cuDNN take TF32, which moves the
    tower's fp32 convolutions and FID by about 1e-2); else PyTorch's
    defaults, as a user runs the tool."""
    t = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO)
    if tf32_off:
        env["NVIDIA_TF32_OVERRIDE"] = "0"
    r = subprocess.run([sys.executable, "-m", f"founddiff_tpu_torch.tools.{module}", *args],
                       capture_output=True, text=True, cwd=REPO, timeout=600, env=env)
    log(f"[{tag}] {module} rc {r.returncode} in {time.perf_counter() - t:.2f} s")
    return r


def doseclip_training(work, root, model, diffusion, wrappers, card):
    """Phase 19 (a): the Dose-CLIP trainer as a subprocess on the card
    (``CLIPIQA()``, bs 8, 6 steps on the tree's train512 slices); the towers
    bit for bit the tool's start, the trained set moved; one step's loss
    terms and gradients at bs 2, card against CPU; the written file loaded
    strictly as the dose encoder of phase 3's model and one bs1 bf16 DDIM-2
    request with phase 3's launches."""
    import copy

    from founddiff_tpu_torch.data import DoseDataset
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.clip import CLIPIQA
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler
    from founddiff_tpu_torch.tools import train_doseclip as tool

    if len(DoseDataset("train512", root=root)) < DOSECLIP_BATCH:
        write_eval_tree(root, "train512", DOSECLIP_BATCH, seed=19)
    out = os.path.join(work, "dose_clip")
    r = _run_tool("train_doseclip", "--data_root", root, "--steps", str(DOSECLIP_STEPS),
                  "--batch_size", str(DOSECLIP_BATCH), "--out", out, "--device", "cuda",
                  tag="doseclip", tf32_off=False)
    if r.returncode != 0:
        raise AssertionError(f"train_doseclip: rc {r.returncode}: {r.stderr[-2000:]}")
    summary = [line.split("] ", 1)[-1] for line in open(os.path.join(out, "train.log"))
               if "steps/s" in line][-1]
    m = re.search(r"(\d+) steps, (\d+) with a non-finite loss: first step ([\d.]+) s, then "
                  r"([\d.]+) steps/s; peak memory ([\d.naninf]+) GiB", summary)
    if not m or int(m.group(1)) != DOSECLIP_STEPS or int(m.group(2)) != 0:
        raise AssertionError(f"train_doseclip: {summary!r}")
    steps_per_s, peak = float(m.group(4)), float(m.group(5))
    path = os.path.join(out, "dose_clip_final.pth")
    trained = torch.load(path, map_location="cpu", weights_only=True)
    start = CLIPIQA()
    init_params(start, torch.Generator().manual_seed(0))  # the tool's init
    tower_same, moved = 0, []
    for k, v in start.state_dict().items():
        if k.startswith("clip_model."):
            if not torch.equal(trained[k], v):
                raise AssertionError(f"train_doseclip: the frozen {k} changed")
            tower_same += 1
        elif not torch.equal(trained[k], v):
            moved.append(k)
    want_moved = sorted(tool.trained_tensors(start))
    if sorted(moved) != want_moved:
        raise AssertionError(f"train_doseclip: moved {sorted(moved)}, want {want_moved}")

    # one step at bs 2: the three terms and the trained tensors' gradients, on
    # the tower with its batch-norm statistics set from 4 of the slices (at
    # the seeded statistics every slice gets nearly the same dose embedding,
    # and BMC's distances, square roots near 0, are rounding on either side)
    ds = DoseDataset("train512", root=root)
    views = tool._views(np.stack([ds[i][0][0] for i in range(4)]), "cpu")
    set_bn_stats(start, lambda: start.clip_model.encode_image(views))
    items = [ds[i] for i in range(DOSECLIP_CHECK_BATCH)]
    batch = ((np.stack([it[0][0] for it in items]), np.stack([it[0][1] for it in items])),
             np.stack([it[1] for it in items]))
    got = {}
    for name, m_ in (("cpu", start), ("card", copy.deepcopy(start).cuda())):
        grads = tool.freeze_towers(m_.eval())
        loss, aux = tool.loss_fn(m_, batch)
        loss.backward()
        got[name] = ({k: float(v.detach()) for k, v in aux.items()},
                     {k: t.grad.detach().float().cpu() for k, t in grads.items()})
        del m_
    term_err = max(abs(got["card"][0][k] - v) / abs(v) for k, v in got["cpu"][0].items())
    grad_err = max(_rel_err(got["card"][1][k], v) for k, v in got["cpu"][1].items())

    # the written file as the dose encoder of phase 3's model: one request
    model.dose_encoder.load_state_dict(trained, strict=True)
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(19).random((1, 512, 512, 1),
                                                          dtype=np.float32)).cuda()
    wrappers.reset()
    t = time.perf_counter()
    y = sampler(x, generator=torch.Generator().manual_seed(19))
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t
    launches = wrappers.used()
    forwards = 2
    want = {k: n * forwards for k, n in PER_FORWARD.items()}
    if launches != want or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"the trained tower's request: launches {launches}, want {want}, "
                             f"finite {bool(torch.isfinite(y).all())}")
    log(f"[doseclip] train_doseclip CLIPIQA() bs {DOSECLIP_BATCH}, {DOSECLIP_STEPS} steps on "
        f"{512}^2: {steps_per_s:.3f} steps/s after the first ({m.group(3)} s), peak memory "
        f"{peak:.2f} GiB; {tower_same} tower tensors bit for bit, {len(moved)} trained moved "
        f"[{card}]")
    log(f"[doseclip] one step at bs {DOSECLIP_CHECK_BATCH}, card against CPU: loss terms "
        f"{term_err:.3e}, gradients {grad_err:.3e} relative (bound {CLIP_RTOL}); the file as "
        f"the dose encoder: bs1 bf16 DDIM-2 request {request_s:.3f} s, launches {launches}")
    if not (term_err <= CLIP_RTOL and grad_err <= CLIP_RTOL):
        raise AssertionError(f"the Dose-CLIP step: terms {term_err:.3e}, gradients "
                             f"{grad_err:.3e}")
    return dict(steps_per_s=steps_per_s, first_step_s=float(m.group(3)), peak_memory_gib=peak,
                tower_tensors_same=tower_same, moved=len(moved), term_err=term_err,
                grad_err=grad_err, request_s=request_s, launches=launches), path


def clip_families(slices, card):
    """Phase 19 (b): ``build_clip_from_state_dict`` on seeded tensors of
    ViT-B/32's and RN50's stock layout (the ints and BatchNorm counters of a
    stock file beside them); tokens from the port tokenizer on the fixture
    vocabulary; the CLIP forward's logits, card against CPU, and the ViT's
    ``encode_image(pos_embedding=True)`` at 512^2 (257 tokens against 50)."""
    import copy

    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.clip import CLIP
    from founddiff_tpu_torch.models.tokenizer import CT_PROMPTS, ClipTokenizer
    from founddiff_tpu_torch.utils.clip_build import build_clip_from_state_dict
    from founddiff_tpu_torch.utils.iqa import clip_preprocess

    tok = ClipTokenizer(bpe_path=FIXTURE_BPE)
    ids = torch.from_numpy(tok.tokenize(list(CT_PROMPTS) + ["a ct slice of the abdomen"])).long()
    rgb = slices.repeat_interleave(3, dim=-1)
    x224 = clip_preprocess(rgb)
    out = {}
    for name, shape in (("ViT-B/32", VIT_B32), ("RN50", RN50)):
        src = CLIP(**shape)
        init_params(src, torch.Generator().manual_seed(190))
        sd = dict(src.state_dict(), input_resolution=torch.tensor(224),
                  context_length=torch.tensor(77), vocab_size=torch.tensor(49408))
        for k in list(sd):
            if k.endswith("running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
        del src
        t = time.perf_counter()
        cpu = build_clip_from_state_dict(sd)
        build_s = time.perf_counter() - t
        gpu = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            logits_cpu, feats_cpu = cpu(x224, ids)
            logits, feats = gpu(x224.cuda(), ids.cuda())
            err = max(_rel_err(logits, logits_cpu), _rel_err(feats, feats_cpu))
            rec = dict(build_s=build_s, logits_err=err, logits_shape=list(logits.shape))
            if isinstance(shape["vision_layers"], int):
                x512 = rgb * 2 - 1
                rec["pos512_err"] = _rel_err(gpu.encode_image(x512.cuda(), pos_embedding=True),
                                             cpu.encode_image(x512, pos_embedding=True))
                patch = shape["vision_patch_size"]
                rec["tokens"] = (512 // patch) ** 2 + 1
                rec["tokens_native"] = (shape["image_resolution"] // patch) ** 2 + 1
        out[name] = rec
        log(f"[clip {name}] build_clip_from_state_dict {build_s:.2f} s; CLIP(image, text) "
            f"{tuple(logits.shape)} card against CPU {err:.3e}"
            + (f"; encode_image(pos_embedding=True) at 512^2 ({rec['tokens']} tokens against "
               f"{rec['tokens_native']}) {rec['pos512_err']:.3e}" if "pos512_err" in rec
               else "") + f" (bound {CLIP_RTOL}) [{card}]")
        bad = [k for k in ("logits_err", "pos512_err") if rec.get(k, 0.0) > CLIP_RTOL]
        if bad:
            raise AssertionError(f"CLIP {name}: {bad} {rec}")
        del cpu, gpu
    return out


def lpips_and_preprocess(slices, card):
    """Phase 19 (c): a seeded LPIPS at 256^2 bs 4 and ``clip_preprocess`` of
    4 x 512^2 slices to 224^2, card against CPU."""
    import copy

    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models import LPIPS
    from founddiff_tpu_torch.utils.iqa import clip_preprocess
    from founddiff_tpu_torch.utils.resize import resize

    rgb = slices.repeat_interleave(3, dim=-1)
    pre_err = _rel_err(clip_preprocess(rgb.cuda()), clip_preprocess(rgb))
    ms = cuda_ms(lambda: clip_preprocess(rgb.cuda()))
    cpu = LPIPS()
    init_params(cpu, torch.Generator().manual_seed(191))
    gpu = copy.deepcopy(cpu).cuda()
    a = resize(rgb, (4, 256, 256, 3), "bilinear") * 2 - 1
    b = a.flip(2)
    with torch.no_grad():
        lp_err = _rel_err(gpu(a.cuda(), b.cuda()), cpu(a, b))
        lp_ms = cuda_ms(lambda: gpu(a.cuda(), b.cuda()))
    log(f"[iqa] clip_preprocess 4 x 512^2 -> 224^2 card against CPU {pre_err:.3e} ({ms:.3f} "
        f"ms); LPIPS 4 x 256^2 {lp_err:.3e} ({lp_ms:.3f} ms) (bound {IQA_RTOL}) [{card}]")
    if not (pre_err <= IQA_RTOL and lp_err <= IQA_RTOL):
        raise AssertionError(f"iqa: clip_preprocess {pre_err:.3e}, LPIPS {lp_err:.3e}")
    return dict(clip_preprocess_err=pre_err, clip_preprocess_ms=ms, lpips_err=lp_err,
                lpips_ms=lp_ms)


def result_tools(work, root, tower_path, card):
    """Phase 19 (d): the FID tool and ``analyze_results`` as subprocesses on
    phase 16's predictions and their ground truths (the NDCT slices as the
    test set gives them): the FID tool with (a)'s file (its batch-norm
    statistics set from the ground truths) against ``compute_fid`` in
    process, the FID tool without weights, and the report against the
    port's metrics on the same files."""
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.data import PDFDataset, define_label
    from founddiff_tpu_torch.models.clip import CLIPIQA
    from founddiff_tpu_torch.ops.metrics import compute_psnr, compute_rmse, compute_ssim
    from founddiff_tpu_torch.tools import fid_and_inception_score as fid_tool
    from founddiff_tpu_torch.utils.fid import compute_fid, make_clip_extractor

    pred = os.path.join(work, "checkpoints", "eval", "test_final_npy")
    gt = os.path.join(work, "gt")
    os.makedirs(gt, exist_ok=True)
    d = Config().data
    ds = PDFDataset("test", root=root, subset=d.subset, doses=d.doses, num=d.num,
                    stride=d.stride)
    names = {ds.load_name(i): i for i in range(len(ds))}
    preds = sorted(os.listdir(pred))
    if not preds or any(p not in names for p in preds):
        raise AssertionError(f"phase 16's predictions {preds[:4]} are not the test set's")
    for p in preds:
        np.save(os.path.join(gt, p), ds[names[p]][0][..., 0])

    # (a)'s tower with its batch-norm statistics set from the ground truths, as
    # phase 16 sets its tower's: at the seeded statistics the features hardly
    # move between slices and FID reads the eps offset alone
    tower = CLIPIQA()
    tower.load_state_dict(torch.load(tower_path, map_location="cpu", weights_only=True),
                          strict=True)
    tower = tower.cuda().eval()
    calibrate_tower(tower, torch.from_numpy(fid_tool.load_dir(gt)[:8]).cuda())
    calibrated = os.path.join(work, "dose_clip_calibrated.pth")
    torch.save({k: v.cpu() for k, v in tower.state_dict().items()}, calibrated)
    r = _run_tool("fid_and_inception_score", pred, "--reference_dir", gt, "--clip_weights",
                  calibrated, "--device", "cuda", tag="fid tool")
    if r.returncode != 0:
        raise AssertionError(f"fid tool: rc {r.returncode}: {r.stderr[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    fid_in = compute_fid(fid_tool.load_dir(pred), fid_tool.load_dir(gt),
                         make_clip_extractor(tower))
    del tower
    fid_err = abs(line["fid_doseclip"] - fid_in) / abs(fid_in)
    refused = _run_tool("fid_and_inception_score", pred, "--reference_dir", gt, "--device",
                        "cuda", tag="fid tool, no weights")
    log(f"[fid tool] {line['n_generated']} against {line['n_reference']} slices: fid_doseclip "
        f"{line['fid_doseclip']!r}, in process {fid_in!r} ({fid_err:.3e} relative, bound "
        f"{FID_TOOL_RTOL}); keys {sorted(line)}; without weights rc {refused.returncode}")
    if (set(line) != FID_KEYS or fid_err > FID_TOOL_RTOL or line["n_generated"] != len(preds)
            or not fid_in > 0
            or refused.returncode == 0 or fid_tool.REFUSAL not in refused.stderr):
        raise AssertionError(f"fid tool: {line}, in process {fid_in!r}, refusal rc "
                             f"{refused.returncode}: {refused.stderr[-500:]}")

    r = _run_tool("analyze_results", pred, gt, "--device", "cuda", tag="analyze")
    if r.returncode != 0:
        raise AssertionError(f"analyze_results: rc {r.returncode}: {r.stderr[-2000:]}")
    report = json.loads(r.stdout)
    groups = {}
    for p in preds:
        a, b = (torch.from_numpy(np.load(os.path.join(dd, p)).astype(np.float32))
                [None, ..., None].cuda() for dd in (pred, gt))
        groups.setdefault(f"{p.split('-')[0]}/dose_1_{define_label(os.path.join(pred, p))}",
                          []).append([float(f(a, b)) for f in (compute_psnr, compute_ssim,
                                                               compute_rmse)])
    worst = 0.0
    for k, ms in groups.items():
        want = np.round(np.asarray(ms).mean(axis=0), 4)
        got = [report[k][m] for m in ("psnr", "ssim", "rmse")]
        worst = max(worst, float(np.abs(np.asarray(got) - want).max()))
        if report[k]["n"] != len(ms):
            raise AssertionError(f"analyze_results {k}: n {report[k]['n']}, want {len(ms)}")
    log(f"[analyze] {len(report)} groups over {len(preds)} slices, PSNR/SSIM/RMSE against the "
        f"port's metrics: max |diff| {worst:.3e} (bound {REPORT_ATOL}); groups {sorted(report)}")
    if sorted(report) != sorted(groups) or worst > REPORT_ATOL:
        raise AssertionError(f"analyze_results: {sorted(report)} against {sorted(groups)}, "
                             f"{worst:.3e}")
    return dict(fid_tool=line["fid_doseclip"], fid_in_process=fid_in, fid_err=fid_err,
                refusal_rc=refused.returncode, report_groups=len(report), report_err=worst)


def trace_hook(work, wrappers, train, card):
    """Phase 19 (e): ``Trainer.train(profile_dir=..., profile_steps=(1, 3))``
    over 4 fp32 steps of ``Config()`` at 512^2: the Chrome trace holds each
    of the port's kernels, by its CUDA symbol, at twice its launches in
    phase 7's profiled step, grouped as TRACE_UNITS; the wrappers launch
    PER_STEP a step."""
    import shutil

    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.train.trainer import Trainer

    per_step = {}
    for r in train["profile"]["kernels"]:
        if PROFILE_GROUPS[0][1](r["name"]):
            per_step[r["name"]] = per_step.get(r["name"], 0) + r["calls"]
    if not per_step:
        raise AssertionError("phase 7's profiled step holds no kernel of the port")
    cfg = Config()
    cfg.train.train_num_steps = 4
    cfg.train.mixed_precision = "no"
    cfg.train.checkpoint_folder = os.path.join(work, "trace_train")
    diffusion, model = build(cfg, device="cuda", seed=0, train=True)
    perturb_gates(model, seed=0)
    trainer = Trainer(diffusion, model, cfg)
    B, S = cfg.train.train_batch_size * cfg.train.gradient_accumulate_every, 512
    gen = torch.Generator().manual_seed(190)
    batches = []
    for _ in range(4):
        gt = torch.rand((B, S, S, 1), generator=gen)
        batches.append((gt, (gt + 0.1 * torch.randn((B, S, S, 1), generator=gen)).clamp(0, 1)))
    prof_dir = os.path.join(work, "trace")
    wrappers.reset()
    t = time.perf_counter()
    trainer.train(batches, log_every=10, profile_dir=prof_dir, profile_steps=(1, 3))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = wrappers.used()
    del trainer, model, diffusion
    torch.cuda.empty_cache()
    files = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
    size_mb = sum(os.path.getsize(f) for f in files) / 2 ** 20
    t = time.perf_counter()
    events = json.load(open(files[0]))["traceEvents"]
    shutil.rmtree(prof_dir)
    counts = {}
    for e in events:
        if e.get("cat") == "kernel" and PROFILE_GROUPS[0][1](e["name"]):
            counts[e["name"][:120]] = counts.get(e["name"][:120], 0) + 1
    parse_s = time.perf_counter() - t
    del events
    if len(files) != 1 or launches != {k: 4 * n for k, n in PER_STEP.items()}:
        raise AssertionError(f"trace hook: {len(files)} trace files, launches {launches}")
    wrong = {k: (counts.get(k, 0), 2 * per_step.get(k, 0)) for k in set(counts) | set(per_step)
             if counts.get(k, 0) != 2 * per_step.get(k, 0)}
    units = {}
    for k, n in counts.items():
        unit = next((u for u, _, keys in TRACE_UNITS if any(key in k for key in keys)), None)
        if unit is None:
            raise AssertionError(f"trace hook: no unit for the port's kernel {k}")
        group = units.setdefault(unit, {})
        group[_kernel_name(k)] = group.get(_kernel_name(k), 0) + n
    log(f"[trace] Config() 512^2 fp32, 4 steps with profile_steps (1, 3): {train_s:.2f} s, "
        f"trace {size_mb:.1f} MiB parsed in {parse_s:.2f} s [{card}]")
    for unit, wr, _ in TRACE_UNITS:
        got = units.get(unit, {})
        log(f"[trace] {unit}: {sum(got.values())} kernels in steps 1-2 (wrapper launches "
            f"{sum(2 * PER_STEP[w] for w in wr)}): " + ", ".join(
                f"{k} {n}" for k, n in sorted(got.items())))
    if wrong or any(not units.get(u) for u, _, _ in TRACE_UNITS):
        raise AssertionError(f"trace hook: (trace, 2 x phase 7) differ {wrong}; units "
                             f"{sorted(units)}")
    return dict(train_s=train_s, trace_mib=size_mb, units=units, launches=launches)


def doseclip_and_tools(model, diffusion, wrappers, record, card):
    """Phase 19: the Dose-CLIP family and the tools, on phase 16's tree and
    predictions, in phase 16's working directory (``main`` removes it)."""
    from founddiff_tpu_torch.data import PDFDataset

    t19 = time.perf_counter()
    work = record["eval"]["work"]
    root = os.path.join(work, "mayo")
    out = {}
    out["doseclip"], tower_path = doseclip_training(work, root, model, diffusion, wrappers,
                                                    card)
    ds = PDFDataset("test", root=root)
    slices = torch.from_numpy(np.stack([ds[i][0] for i in range(4)]))
    out["clip"] = clip_families(slices, card)
    out["iqa"] = lpips_and_preprocess(slices, card)
    out["tools"] = result_tools(work, root, tower_path, card)
    torch.cuda.empty_cache()
    out["trace"] = trace_hook(work, wrappers, record["train"], card)
    out["seconds"] = time.perf_counter() - t19
    log(f"[phase 19] {out['seconds']:.1f} s")
    return out


def psnr(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


class Launches:
    """The port's kernel launches by wrapper, read from the program's
    counter registry (``founddiff_tpu_torch.utils.trace``, one count per
    launch under the C entry's name) since the last :meth:`reset`.
    Iterating gives the wrappers' names."""

    ENTRIES = {
        "ss2d_image_block": ("ss2d_block_forward", "ss2d_block_forward.silu"),
        "attn_block": ("attn_block_forward",), "layer_norm_modulated": ("ln_mod_forward",),
        "scan_forward": ("scan_forward",), "scan_backward": ("scan_backward",),
        "scan_image_forward": ("scan_image_forward",), "flash_fwd": ("flash_fwd",),
        "flash_bwd_dq": ("flash_bwd_dq",), "flash_bwd_dkv": ("flash_bwd_dkv",),
        "gn_stats": ("gn_stats_forward",), "gn_apply": ("gn_apply_forward",),
        "ss2d_mamba_block": ("mamba_block_forward",), "scan_fused_forward": ("scan_fused_forward",),
        "layer_norm": ("ln_forward",), "merge_ln_gate": ("ss2d_epilogue_forward",),
    }

    def __init__(self):
        self.reset()

    def __iter__(self):
        return iter(self.ENTRIES)

    def reset(self):
        from founddiff_tpu_torch.utils import trace

        self._since = trace.counters()

    def _delta(self):
        from founddiff_tpu_torch.utils import trace

        return trace.counters(self._since)

    def counts(self) -> dict:
        """Launches of every wrapper (``ss2d_image_block``'s with and without
        ``silu_input``)."""
        delta = self._delta()
        return {k: sum(delta.get(e, 0) for e in entries) for k, entries in self.ENTRIES.items()}

    def used(self) -> dict:
        return {k: n for k, n in self.counts().items() if n}

    def silu(self) -> int:
        """The ``ss2d_image_block`` launches with ``silu_input``."""
        return self._delta().get("ss2d_block_forward.silu", 0)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    for k in (*ROUTES, "FOUNDDIFF_SILU"):  # the default routes; 10, 11 and 18 set theirs
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
        SILU_KERNEL: (
            lambda *a, **k: ss2d_mod.ss2d_image_block(*a, silu_input=True, **k),
            lambda *a, **k: ss2d_mod.ss2d_image_block_plain(*a, silu_input=True, **k)),
    }
    ops.update({k: ops[SITE_WRAPPER[k]] for k in SITES[1:]})
    wrappers = Launches()

    # phase 2: kernels against their plain versions
    cases = [(b, *c) for b in (1, 4) for c in kernel_cases(b)]
    cases += [(TRAIN_BATCH, *c) for c in train_cases()]
    cases += flash_cases()
    cases += [(b, *c) for b in (1, TRAIN_BATCH, 4) for c in route_cases(b)]
    cases += [(b, *c) for b in (1, TRAIN_BATCH, 4) for c in unfused_cases(b)]
    cases += slice6_cases()
    cases += slice7_cases()
    cases += options_cases()
    rows, failed = check_kernels(ops, cases)
    bounds, bounds_failed = check_fused_h_bounds()
    failed += bounds_failed
    bounds_only, bounds_only_failed = check_bounds_only(cases)
    failed += bounds_only_failed
    last_state, last_state_failed = check_last_state(cases)
    failed += last_state_failed
    record = dict(card=card, build_seconds=built["seconds"], ptxas=built["logs"],
                  kernel_cases=rows, fused_h_bounds=bounds, bounds_only=bounds_only,
                  last_state=last_state,
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
    try:
        # phase 16: the evaluation entry point
        torch.cuda.empty_cache()
        record["eval"] = eval_entry(wrappers, plain_default, card)
        # phase 17: distribution
        torch.cuda.empty_cache()
        t17 = time.perf_counter()
        record["seq_shards"] = seq_virtual_shards(wrappers, card)
        record["distributed"] = distributed(wrappers, plain_default, card, model, diffusion,
                                            record["train"])
        record["phase17_s"] = time.perf_counter() - t17
        log(f"[phase 17] {record['phase17_s']:.1f} s")
        # phase 18: the model and loss options
        torch.cuda.empty_cache()
        record["options"] = options(
            request, x_all, outs, wrappers, plain_default,
            {**plain_all, (blocks_mod, "flash_attention"): flash_mod.flash_attention_plain},
            steps, record, card)
        # phase 19: the Dose-CLIP family and the tools
        torch.cuda.empty_cache()
        record["doseclip_tools"] = doseclip_and_tools(model, diffusion, wrappers, record, card)
    finally:
        import shutil

        shutil.rmtree(EVAL_WORK, ignore_errors=True)

    kernels = []
    for k, (src, tpu) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == k]
        if k in SERVING:  # one bs1 bf16 UNet forward
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = main["launches"][k]
        elif k == "ss2d_mamba_block":  # one bs1 bf16 UNet forward, both routes on
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = record["routes"]["launches"][k]
        elif k == SILU_KERNEL:  # one bs1 bf16 UNet forward with FOUNDDIFF_SILU=kernel
            main_rows = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
            n = record["options"]["serving"]["launches_silu"]
        elif k in SITES:  # the call of phase 18's bs1 fp32 variant
            main_rows = [r for r in mine if r["dtype"] == "float32" and r["batch"] == 1]
            n = record["options"]["variants"]["sites"][k]
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
        errs = [r["max_abs_err"] for r in mine]
        if k == "scan_forward":  # its last-state mode's h_last, held in phase 2 too
            errs += [r["max_abs_err"] for r in record["last_state"]]
        states = sorted({int(w[2:]) for r in mine for w in r["shape"].split()
                         if w.startswith("N=")})
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=tpu, launches=n,
            max_abs_err=max(errs), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms") if main_rows[0]["library_ms"] is not None else None,
            **({"d_state": states} if states else {}),
            **({"units": record["units"][k]} if k in record["units"] else {}),
            **({"last_state": last_state_summary(record)} if k == "scan_forward" else {})))
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
