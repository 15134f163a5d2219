#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero before the last line is printed):

1. Device and build: requires CUDA, prints the card's name and power limit,
   turns TF32 off for every fp32 comparison, builds the three kernel
   libraries from ``founddiff_tpu_torch/csrc`` (one nvcc per source, all
   started together) and prints the build seconds.
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every distinct shape the 512^2 serving path gives it (bs1
   and bs4), in fp32 and bf16, with the stated tolerance; prints the errors, the
   kernel's and the plain version's times (CUDA events, warmed up, median
   of 7) and the bound (the larger of bytes / 3.35 TB/s and operations /
   peak rate).
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

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
phase 3, the worst error of phase 2, and the summed times of one bs1 bf16
UNet forward's calls); the last is ``{"ok": true, "device": {...}}``.  A
longer record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
# kernel-name groups of the profile, first match wins
PROFILE_GROUPS = (
    ("port kernels", ("fd::", "(anonymous namespace)::")),
    ("cuDNN/cuBLAS convolutions and matmuls", ("xmma", "cutlass", "conv2d", "gemm", "cudnn")),
)

SOURCES = {
    "ss2d_image_block": ("founddiff_tpu_torch/csrc/ss2d_block.cu",
                         "founddiff_tpu/ops/ss2d_block.py:50"),
    "attn_block": ("founddiff_tpu_torch/csrc/attn_block.cu",
                   "founddiff_tpu/ops/attn_block.py:104"),
    "layer_norm_modulated": ("founddiff_tpu_torch/csrc/ln_mod.cu",
                             "founddiff_tpu/ops/norm_pallas.py:123"),
}


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
    in bf16, 67e12: fp32 CUDA cores).  Work on one unit adds up; the units
    and the memory run at once, so the least time in ms is the largest of
    bytes over the memory rate and each unit's operations over its peak rate.
    Returns it and its two parts."""
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


def check_kernels(ops):
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    rows, failed = [], []
    for batch, kname, label, count, make in [(b, *c) for b in (1, 4) for c in kernel_cases(b)]:
        kernel, plain = ops[kname]
        for dtype in (torch.float32, torch.bfloat16):
            args, kw, base, moved, work = make(dtype, gen, dev)
            got = kernel(*args, **kw).float()
            want = plain(*args, **kw).float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            computed = want if base is None else want - base.float()
            scale = computed.abs().max().item()
            out_ulp = ulp(torch.maximum(got.abs(), want.abs()), dtype)
            atol, rtol = TOL[dtype]
            tol = atol + rtol * scale
            err = diff.max().item()
            # the worst error beyond the output's own rounding
            excess = (diff - out_ulp).clamp_min(0).max().item()
            finite = bool(torch.isfinite(got).all())
            ok = finite and excess <= tol
            ms = cuda_ms(lambda: kernel(*args, **kw))
            pms = cuda_ms(lambda: plain(*args, **kw))
            bms, t_bytes, t_ops = bound_ms(moved, work)
            by = "bytes" if t_bytes >= t_ops else "operations"
            row = dict(kernel=kname, shape=label, batch=batch,
                       dtype=str(dtype).replace("torch.", ""),
                       per_forward=count, max_abs_err=err, err_past_ulp=excess,
                       max_abs_computed=scale, tol=tol, ok=ok, ms=ms, plain_ms=pms, bound_ms=bms, bytes_ms=t_bytes,
                       ops_ms=t_ops, bound_by=by)
            rows.append(row)
            log(f"[kernel] {kname:21s} {label:32s} {row['dtype']:8s} err {err:.3e}, "
                f"past 1 ulp {excess:.3e} (tol {tol:.3e}, computed part max {scale:.3e}) "
                f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
                f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by})")
            if not ok:
                failed.append(f"{kname} {label} {row['dtype']}")
            del args, got, want
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


def profile_request(request, x, top: int = 25):
    """Device time by kernel name over one request, and the device's busy
    share of the request's wall time (kernels run on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request(x, 9)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [dict(name=e.key[:120], calls=e.count, ms=e.self_device_time_total / 1e3)
            for e in kernels]
    groups = {}
    for r in rows:
        g = next((name for name, keys in PROFILE_GROUPS if any(k in r["name"] for k in keys)),
                 "other PyTorch kernels")
        calls, ms = groups.get(g, (0, 0.0))
        groups[g] = (calls + r["calls"], ms + r["ms"])
    tag = f"bs{x.shape[0]}"
    log(f"[profile {tag}] wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(r['calls'] for r in rows)} kernel launches")
    for g, (calls, ms) in groups.items():
        log(f"[profile {tag}] group {g}: {ms:.3f} ms in {calls} launches")
    for r in rows[:top]:
        log(f"[profile {tag}] {r['ms']:9.3f} ms {r['calls']:6d}x  {r['name']}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, groups=groups, kernels=rows)


def psnr(a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(1.0 / mse)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    from founddiff_tpu_torch.ops import _build
    from founddiff_tpu_torch.ops import attn_block as attn_mod
    from founddiff_tpu_torch.ops import norm as norm_mod
    from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: build
    built = _build.build_all()
    log(f"[build] {built['seconds']:.1f} s for {', '.join(_build.SOURCES)}")
    for name, text in built["logs"].items():
        regs = [int(w) for line in text.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt.startswith("registers")]
        spills = sum("0 bytes spill stores" not in line
                     for line in text.splitlines() if "spill stores" in line)
        log(f"[ptxas {name}] {len(regs)} kernels, at most {max(regs, default=0)} registers, "
            f"{spills} with spills")

    ops = {
        "ss2d_image_block": (ss2d_mod.ss2d_image_block, ss2d_mod.ss2d_image_block_plain),
        "attn_block": (attn_mod.attn_block, attn_mod.attn_block_plain),
        "layer_norm_modulated": (norm_mod.layer_norm_modulated,
                                 norm_mod.layer_norm_modulated_plain),
    }
    wrappers = {k: v[0] for k, v in ops.items()}

    # phase 2: kernels against their plain versions
    rows, failed = check_kernels(ops)
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
    per_forward = {"ss2d_image_block": 9, "attn_block": 6, "layer_norm_modulated": 12}
    for k, n in per_forward.items():
        if launches[k] != n * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches in {forwards} UNet forwards, "
                                 f"want {n} per forward")
    for o in outs:
        if o.shape[1:] != (size, size, 1) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"bad output {tuple(o.shape)} finite={torch.isfinite(o).all()}")
        if float(o.min()) < 0.0 or float(o.max()) > 1.0:
            raise AssertionError("output leaves the [0, 1] window")
    sps1 = 1.0 / statistics.median(t_bs1)
    sps4 = 4.0 / statistics.median(t_bs4)
    log(f"[main] launches {launches} over {forwards} UNet forwards "
        f"({per_forward} per forward)")
    log(f"[main] DDIM-{steps} {size}^2 bf16: bs1 {sps1:.3f} slices/s "
        f"(request s {[round(t, 4) for t in t_bs1]}), bs4 {sps4:.3f} slices/s "
        f"(batch s {[round(t, 4) for t in t_bs4]}), peak memory {peak_gib:.2f} GiB [{card}]")
    record["main"] = dict(launches=launches, forwards=forwards, bs1_slices_per_s=sps1,
                          bs4_slices_per_s=sps4, bs1_request_s=t_bs1, bs4_batch_s=t_bs4,
                          peak_memory_gib=peak_gib, steps=steps, size=size)

    # phase 4: numerics gate, kernel path against the plain path
    x1 = x_all[:1]
    fused = request(x1, 7)
    saved = {n: getattr(ss2d_model, n) for n in per_forward}
    try:
        ss2d_model.ss2d_image_block = ss2d_mod.ss2d_image_block_plain
        ss2d_model.attn_block = attn_mod.attn_block_plain
        ss2d_model.layer_norm_modulated = norm_mod.layer_norm_modulated_plain
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
    record["profile"] = {f"bs{len(x)}": profile_request(request, x) for x in (x_all[:1], x_all)}

    kernels = []
    for k, (src, tpu) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == k]
        main_bf16 = [r for r in mine if r["dtype"] == "bfloat16" and r["batch"] == 1]
        total = lambda key: sum(r[key] * r["per_forward"] for r in main_bf16)
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=tpu, launches=launches[k],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=None))
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
