#!/usr/bin/env python3
"""Time two trees of the PyTorch/CUDA port in turns on one card, and compare
the bits of the kernels the newer tree leaves alone.

    python scripts/port_ab.py --parent DIR [--change DIR] [--turns 2]

Each DIR holds a checkout of the repository (for example ``git archive`` of
a commit unpacked into a directory that git ignores); ``--change`` defaults
to the tree this script lies in.  The trees run in turns, parent, change,
change, parent (``--turns 2``), each turn a worker process started from its
tree, so that each imports its own ``founddiff_tpu_torch`` and
``chip_smoke.py`` and builds its own kernels.  A worker measures, with
CUDA events (median of 7 after 2 warm-ups) on inputs made from a seed by
its tree's ``chip_smoke.py`` case functions:

- the redesigned kernels, ``scan_fused_forward`` and ``merge_ln_gate``,
  event and device time (``torch.profiler``) of one call and the device
  time of each of its launches by kernel, at each shape of their units
  (``unfused_cases``): ``scan_fused_forward`` at the three 45^2 MambaBlocks
  of a bs1 and of a bs4 bf16 360^2 UNet forward and of the fp32 360^2
  train step (2 slices a microbatch, 6 calls a step), ``merge_ln_gate`` at
  the three 2x2 MambaBlocks of a bs1 and of a bs4 bf16 16^2 UNet forward;
  and ``scan_image_forward``, which shares the scan's chunk passes, at the
  five image-route shapes of the fp32 512^2 train step (``train_cases``,
  10 calls a step); and their sums over each unit;
- ``share``: where the device time of one bs4 bf16 360^2 DDIM-2 request
  goes (``profile_device``): the fused scan's launches, named by the
  kernel rows above, against the other port kernels, cuDNN/cuBLAS and the
  other PyTorch kernels;
- the fp32 train step of ``Config()`` at 512^2 and 360^2 (chip_smoke's
  ``train_full_width`` without its bf16 steps: a warm-up step, then the
  median of 3, host clock around work that ends in
  ``torch.cuda.synchronize()``), with its launch counts checked;
- DDIM-2 serving of ``Config()`` in bf16 at 512^2 and 360^2: slices/s at bs1
  (median of 4 requests) and bs4 (median of 2 batches).

In its first turn each tree also hashes (sha256) the outputs of every
phase-2 case of the kernels listed in ``UNTOUCHED``, fp32 and bf16, at
inputs seeded by the case's name, so that the two trees' bits can be
compared.  ``--parts`` picks what a worker measures (``hash``,
``kernels``, ``share``, ``train``, ``serving``; all by default; ``share``
needs ``kernels``).  Needs one CUDA card.
Writes ``chiprun_out/port_ab.json`` under the working directory and prints a
table.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDESIGNED = ("scan_fused_forward", "merge_ln_gate")
# scan_image_forward is timed beside them (it shares their chunk passes) and
# hashed as untouched (its bits must not move)
UNTOUCHED = ("ss2d_image_block", "attn_block", "layer_norm_modulated", "scan_forward",
             "scan_backward", "scan_image_forward", "layer_norm", "gn_stats", "gn_apply",
             "ss2d_mamba_block", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PARTS = ("hash", "kernels", "share", "train", "serving")
# the modules of the kernels whose launches a train step counts
WRAPPED = (("ss2d_image_block", "ss2d_block"), ("attn_block", "attn_block"),
           ("layer_norm_modulated", "norm"), ("scan_forward", "scan"),
           ("scan_backward", "scan"), ("scan_image_forward", "scan"),
           ("flash_fwd", "flash_attention"), ("flash_bwd_dq", "flash_attention"),
           ("flash_bwd_dkv", "flash_attention"),
           ("gn_stats", "groupnorm"), ("gn_apply", "groupnorm"),
           ("ss2d_mamba_block", "experimental_unified"), ("scan_fused_forward", "scan"),
           ("layer_norm", "norm"), ("merge_ln_gate", "ss2d_fused"))


def _ops():
    """kernel name -> wrapper, as chip_smoke.py calls them in phase 2."""
    from founddiff_tpu_torch.ops import attn_block as attn_mod
    from founddiff_tpu_torch.ops import experimental_unified as unified_mod
    from founddiff_tpu_torch.ops import flash_attention as flash_mod
    from founddiff_tpu_torch.ops import groupnorm as gn_mod
    from founddiff_tpu_torch.ops import norm as norm_mod
    from founddiff_tpu_torch.ops import scan as scan_mod
    from founddiff_tpu_torch.ops import ss2d_block as ss2d_mod
    from founddiff_tpu_torch.ops import ss2d_fused as fused_mod

    return {
        "ss2d_image_block": ss2d_mod.ss2d_image_block, "attn_block": attn_mod.attn_block,
        "layer_norm_modulated": norm_mod.layer_norm_modulated,
        "scan_forward": scan_mod.scan_forward, "scan_backward": scan_mod.scan_backward,
        "scan_image_forward": scan_mod.scan_image_forward, "flash_fwd": flash_mod.flash_fwd,
        "flash_bwd_dq": flash_mod.flash_bwd_dq, "flash_bwd_dkv": flash_mod.flash_bwd_dkv,
        "gn_stats": gn_mod.gn_stats, "gn_apply": gn_mod.gn_apply,
        "ss2d_mamba_block": unified_mod.ss2d_mamba_block,
        "scan_fused_forward": scan_mod.scan_fused_forward, "layer_norm": norm_mod.layer_norm,
        "merge_ln_gate": lambda *a, split, **k: (fused_mod.merge_ln_gate_split if split
                                                 else fused_mod.merge_ln_gate)(*a, **k),
    }


def _cases(cs):
    """(batch, kernel, label, calls per forward or step, make) of the
    tree's phase 2 (without the newer tree's additions)."""
    cases = [(b, *c) for b in (1, 4) for c in cs.kernel_cases(b)]
    cases += [(cs.TRAIN_BATCH, *c) for c in cs.train_cases()]
    cases += cs.flash_cases()
    cases += [(b, *c) for b in (1, cs.TRAIN_BATCH, 4) for c in cs.route_cases(b)]
    cases += [(b, *c) for b in (1, cs.TRAIN_BATCH, 4) for c in cs.unfused_cases(b)]
    return cases


def _gen(key: str):
    import torch

    return torch.Generator().manual_seed(zlib.crc32(key.encode()))


def _digest(out) -> str:
    import torch

    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _serve(cs, size: int, card: str):
    import numpy as np
    import torch
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    cfg = Config()
    cfg.diffusion.image_size = size
    diffusion, model = build(cfg, device="cuda", seed=0)
    cs.perturb_gates(model, seed=0)
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).random((4, size, size, 1),
                                                        dtype=np.float32)).cuda()

    def request(xb, seed):
        t0 = time.perf_counter()
        sampler(xb, generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    request(x[:1], 0)
    request(x, 0)
    bs1 = [request(x[i:i + 1], 100 + i) for i in range(4)]
    bs4 = [request(x, 200 + i) for i in range(2)]
    return dict(bs1_slices_per_s=1 / statistics.median(bs1),
                bs4_slices_per_s=4 / statistics.median(bs4), bs1_request_s=bs1, bs4_batch_s=bs4)


def _kernel_name(key: str) -> str:
    """A profiler kernel name without namespaces or parameters, with its
    template arguments, which tell the launches of one template apart:
    ``gemm_kernel<float, RowStrided<float>, EpiGated<float> >``."""
    for drop in ("void ", "(anonymous namespace)::", "fd::"):
        key = key.replace(drop, "")
    return key.split("(")[0]


def _device_split(fn, n: int = 10) -> dict:
    """Device ms of one call by kernel, from ``torch.profiler`` over n calls
    (the rest of its event-timed time is the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            k = _kernel_name(e.key)
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def _redesigned_cases(cs):
    """(kernel, unit, calls per unit, label, dtype, make) of the redesigned
    kernels at each shape of their units."""
    import torch

    cases = []
    for kname, B, unit, dtype, per in (
            ("scan_fused_forward", 1, "bs1 bf16 360^2 forward", torch.bfloat16, 1),
            ("scan_fused_forward", 4, "bs4 bf16 360^2 forward", torch.bfloat16, 1),
            ("scan_fused_forward", cs.TRAIN_BATCH, "fp32 360^2 step", torch.float32, 2),
            ("merge_ln_gate", 1, "bs1 bf16 16^2 forward", torch.bfloat16, 1),
            ("merge_ln_gate", 4, "bs4 bf16 16^2 forward", torch.bfloat16, 1)):
        cases += [(k, unit, per * n, label, dtype, make)
                  for k, label, n, make in cs.unfused_cases(B) if k == kname and n]
    # row 6 runs the chunk passes it shares with scan_fused_forward
    cases += [(k, "fp32 512^2 step", n, label, torch.float32, make)
              for k, label, n, make in cs.train_cases() if k == "scan_image_forward"]
    return cases


def _kernel_rows(cs) -> dict:
    """One call's event ms, device ms and device split by launch, with its
    calls per unit, at each case of :func:`_redesigned_cases`."""
    import torch

    ops = _ops()
    rows = {}
    for kname, unit, count, label, dtype, make in _redesigned_cases(cs):
        key = f"{kname} | {unit} | {label}"
        args, kw = make(dtype, _gen(key), torch.device("cuda"))[:2]
        fn = lambda: ops[kname](*args, **kw)
        split = _device_split(fn)
        rows[key] = dict(kernel=kname, unit=unit, per_unit=count, ms=cs.cuda_ms(fn),
                         device_ms=sum(split.values()), split=split)
        del args, kw
        torch.cuda.empty_cache()
    return rows


def _fused_scan_launch(name: str, mine) -> bool:
    """Whether a profiled kernel is one of the fused scan's: a name of its
    rows, or one only its calls launch (the serving call writes no h_bounds,
    so its pass 2 is another template than its rows' in the newer tree):
    the projection GEMM on strided rows, its chunk passes and its carry."""
    n = _kernel_name(name)
    return (n in mine or ("RowStrided" in n and ("EpiProj" in n or "chunk_pass_kernel" in n))
            or n.startswith("fused_chunk_kernel") or n in ("carry_kernel",
                                                           "carry_scan_kernel<false, 4>"))


def _share(cs, rows) -> dict:
    """Device ms of one bs4 bf16 360^2 DDIM-2 request by group: the fused
    scan's launches (:func:`_fused_scan_launch`), the other port kernels,
    cuDNN/cuBLAS and the other PyTorch kernels; and the device's busy ms."""
    import numpy as np
    import torch
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    mine = {k for r in rows.values() if r["kernel"] == "scan_fused_forward" for k in r["split"]}
    cfg = Config()
    cfg.diffusion.image_size = cs.ODD_SIZE
    diffusion, model = build(cfg, device="cuda", seed=0)
    cs.perturb_gates(model, seed=0)
    sampler = make_hoisted_sampler(model, diffusion, compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (4, cs.ODD_SIZE, cs.ODD_SIZE, 1), dtype=np.float32)).cuda()
    run = lambda: sampler(x, generator=torch.Generator().manual_seed(9))
    run()
    torch.cuda.synchronize()
    prof = cs.profile_device(run, "ab share 360 bs4", top=0)
    groups = {"scan_fused_forward": 0.0}
    for r in prof["kernels"]:
        g = ("scan_fused_forward" if _fused_scan_launch(r["name"], mine) else
             next((n for n, match in cs.PROFILE_GROUPS if match(r["name"])),
                  "other PyTorch kernels"))
        groups[g] = groups.get(g, 0.0) + r["ms"]
    del model, diffusion, sampler
    torch.cuda.empty_cache()
    return dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"], groups=groups)


def _train(cs, card: str) -> dict:
    """The fp32 train step of Config() at 512^2 and 360^2 (seconds, the
    median of 3 after a warm-up), launch counts checked as chip_smoke does."""
    import importlib

    import torch
    from founddiff_tpu_torch.config import Config

    wrappers = {k: getattr(importlib.import_module(f"founddiff_tpu_torch.ops.{m}"), k)
                for k, m in WRAPPED}
    out = {}
    for size, per_step in ((512, cs.PER_STEP), (cs.ODD_SIZE, cs.PER_STEP_360)):
        cfg = Config()
        cfg.diffusion.image_size = size
        r = cs.train_full_width(wrappers, card, cfg, per_step, f"ab train {size}", full=False)
        out[str(size)] = statistics.median(r["step_s"])
        torch.cuda.empty_cache()
    return out


def worker(tree: str, out_path: str, parts) -> None:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from founddiff_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    built = _build.build_all()
    ops = _ops()
    dev = torch.device("cuda")
    rec = dict(tree=tree, card=card, build_s=built["seconds"], hashes={}, rows={}, share={},
               train={}, serving={})
    if "hash" in parts:
        for batch, kname, label, count, make in _cases(cs):
            if kname not in UNTOUCHED:
                continue
            for dtype in (torch.float32, torch.bfloat16):
                key = f"{kname} | {label} | {batch} | {dtype}"
                args, kw = make(dtype, _gen(key), dev)[:2]
                rec["hashes"][key] = _digest(ops[kname](*args, **kw))
                del args, kw
            torch.cuda.empty_cache()
    if "kernels" in parts:
        rec["rows"] = _kernel_rows(cs)
    if "share" in parts:
        rec["share"] = _share(cs, rec["rows"])
    if "train" in parts:
        rec["train"] = _train(cs, card)
    if "serving" in parts:
        rec["serving"] = {str(size): _serve(cs, size, card) for size in (512, cs.ODD_SIZE)}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def _units(rows):
    return sorted({(r["kernel"], r["unit"]) for r in rows.values()})


def _per_unit(rows, kname, unit, key="ms"):
    return sum(r[key] * r["per_unit"] for r in rows.values()
               if (r["kernel"], r["unit"]) == (kname, unit))


def _split_per_unit(rows, kname, unit):
    out = {}
    for r in rows.values():
        if (r["kernel"], r["unit"]) == (kname, unit):
            for k, v in r["split"].items():
                out[k] = out.get(k, 0.0) + v * r["per_unit"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--change", default=HERE)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--worker")
    ap.add_argument("--out")
    ap.add_argument("--parts", default=",".join(PARTS))
    a = ap.parse_args()
    parts = set(a.parts.split(","))
    if a.worker:
        worker(a.worker, a.out, parts)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("port_ab.py needs a CUDA card")
    out_dir = os.path.join(os.getcwd(), "chiprun_out", "port_ab")
    os.makedirs(out_dir, exist_ok=True)
    trees = {"parent": os.path.abspath(a.parent), "change": os.path.abspath(a.change)}
    order = ["parent", "change", "change", "parent"] * (a.turns // 2)
    runs = {"parent": [], "change": []}
    for i, name in enumerate(order):
        path = os.path.join(out_dir, f"{i}_{name}.json")
        t0 = time.perf_counter()
        # each tree hashes in its first turn only
        mine = parts - ({"hash"} if runs[name] else set())
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name],
                        "--out", path, "--parts", ",".join(sorted(mine))], check=True)
        with open(path) as f:
            runs[name].append(json.load(f))
        print(f"[turn {i}] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    card = runs["change"][0]["card"]
    summary = dict(card=card, order=order, kernels={}, split={}, share={}, train={},
                   serving={}, bits={})
    for kname, unit in _units(runs["change"][0]["rows"]):
        for key in ("ms", "device_ms"):
            summary["kernels"][f"{kname} per {unit} {key}"] = {
                n: [_per_unit(r["rows"], kname, unit, key) for r in runs[n]] for n in runs}
    for n in runs:
        summary["split"][n] = {f"{k} per {u}": [_split_per_unit(r["rows"], k, u)
                                                for r in runs[n]]
                               for k, u in _units(runs["change"][0]["rows"])}
        summary["share"][n] = [r["share"] for r in runs[n]]
        summary["train"][n] = [r["train"] for r in runs[n]]
        summary["serving"][n] = [{s: {k: v for k, v in d.items() if k.endswith("per_s")}
                                  for s, d in r["serving"].items()} for r in runs[n]]
    hp, hc = runs["parent"][0]["hashes"], runs["change"][0]["hashes"]
    same = sorted(k for k in hp if hc.get(k) == hp[k])
    differ = sorted(k for k in hp if k in hc and hc[k] != hp[k])
    summary["bits"] = dict(compared=len(set(hp) & set(hc)), identical=len(same), differ=differ,
                           only_parent=sorted(set(hp) - set(hc)))
    with open(os.path.join(os.getcwd(), "chiprun_out", "port_ab.json"), "w") as f:
        json.dump(dict(summary=summary, runs=runs), f, indent=1)
    print(card)
    for k, vals in summary["kernels"].items():
        print(f"[ab] {k:52s} parent {[round(v, 4) for v in vals['parent']]}  "
              f"change {[round(v, 4) for v in vals['change']]}")
    for n in runs:
        for kname, turns in summary["split"][n].items():
            for r in turns:
                print(f"[ab split] {n} {kname}: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in sorted(r.items(), key=lambda x: -x[1])) + " ms")
        for r in summary["share"][n]:
            if r:
                print(f"[ab share 360^2 bs4 request] {n}: busy {r['busy_ms']:.3f} of "
                      f"{r['wall_ms']:.3f} ms: " + ", ".join(
                          f"{g} {v:.3f}" for g, v in r["groups"].items()) + " ms")
        for r in summary["train"][n]:
            print(f"[ab train fp32 step] {n}: " + ", ".join(
                f"{s}^2 {t:.4f} s" for s, t in r.items()))
        for r in summary["serving"][n]:
            print(f"[ab serving] {n}: " + ", ".join(
                f"{s}^2 bs1 {d['bs1_slices_per_s']:.3f} bs4 {d['bs4_slices_per_s']:.3f}"
                for s, d in r.items()) + " slices/s")
    print(f"[ab bits] {len(same)} of {summary['bits']['compared']} untouched-kernel outputs "
          f"identical; differ: {differ[:10]}")
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
