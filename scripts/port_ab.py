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
its tree's ``chip_smoke.py`` case functions, in bf16:

- the redesigned kernels per UNet forward at bs1 and bs4, summed over their
  calls: ``ss2d_image_block`` and ``layer_norm_modulated`` at 512^2,
  ``ss2d_mamba_block`` at 512^2 (the unified route's shapes), and
  ``layer_norm`` at the 360^2 slice's 45^2 blocks beside ``F.layer_norm``;
  each also as device time alone (``torch.profiler``), the rest of its
  time being the host's;
- the device time of ``ss2d_image_block``'s launches over one bs4 512^2
  forward's calls, by kernel (``torch.profiler``): the projection GEMM, the
  scan's chunk passes and carry, the LN statistics, the z GEMM, out_proj;
- DDIM-2 serving of ``Config()`` in bf16 at 512^2 and 360^2: slices/s at bs1
  (median of 4 requests) and bs4 (median of 2 batches), host clock around
  work that ends in ``torch.cuda.synchronize()``.

In its first turn each tree also hashes (sha256) the outputs of every
phase-2 case of the kernels listed in ``UNTOUCHED``, fp32 and bf16, at
inputs seeded by the case's name, so that the two trees' bits can be
compared.  Needs one CUDA card.  Writes ``chiprun_out/port_ab.json`` under
the working directory and prints a table.
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
REDESIGNED = ("ss2d_image_block", "layer_norm_modulated", "layer_norm", "ss2d_mamba_block")
UNTOUCHED = ("attn_block", "scan_forward", "scan_backward", "scan_image_forward",
             "scan_fused_forward", "merge_ln_gate", "gn_stats", "gn_apply", "flash_fwd",
             "flash_bwd_dq", "flash_bwd_dkv")


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


def _device_ms(fn, n: int = 20) -> float:
    """Device time of one call (every kernel it launches), from
    ``torch.profiler`` over n calls: the rest of its event-timed time is the
    host's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / n


SPLIT = (("projection GEMM", "EpiProj"), ("z GEMM", "EpiGate"), ("out_proj", "EpiResidual"),
         ("scan chunk passes", "image_scan_chunk"), ("scan carry", "image_scan_carry"),
         ("LN statistics", "ln_rows"))


def _split(cs, ops):
    """Device time of ss2d_image_block's launches over one bs4 bf16 512^2
    UNet forward's calls, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for kname, label, count, make in cs.kernel_cases(4):
        if kname == "ss2d_image_block":
            args, kw = make(torch.bfloat16, _gen(label), torch.device("cuda"))[:2]
            calls += [(args, kw)] * count
    for args, kw in calls:  # warm-up
        ops["ss2d_image_block"](*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args, kw in calls:
            ops["ss2d_image_block"](*args, **kw)
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in SPLIT}
    out["other"] = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        name = next((n for n, key in SPLIT if key in e.key), "other")
        out[name] += e.self_device_time_total / 1e3
    out["calls"] = len(calls)
    return out


def worker(tree: str, out_path: str, do_hash: bool) -> None:
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
    rec = dict(tree=tree, card=card, build_s=built["seconds"], rows={}, hashes={})
    for batch, kname, label, count, make in _cases(cs):
        if kname in REDESIGNED and count:
            args, kw, _, _, _, *library = make(torch.bfloat16, _gen(label), dev)
            fn = ops[kname]
            row = dict(kernel=kname, batch=batch, per_forward=count,
                       ms=cs.cuda_ms(lambda: fn(*args, **kw)),
                       device_ms=_device_ms(lambda: fn(*args, **kw)),
                       library_ms=cs.cuda_ms(library[0]) if library else None)
            rec["rows"][f"{kname} | {label}"] = row
        if do_hash and kname in UNTOUCHED:
            for dtype in (torch.float32, torch.bfloat16):
                key = f"{kname} | {label} | {batch} | {dtype}"
                args, kw = make(dtype, _gen(key), dev)[:2]
                rec["hashes"][key] = _digest(ops[kname](*args, **kw))
                del args, kw
        torch.cuda.empty_cache()
    rec["split_bs4_512"] = _split(cs, ops)
    rec["serving"] = {str(size): _serve(cs, size, card) for size in (512, cs.ODD_SIZE)}
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def _per_forward(rows, kname, batch, key="ms"):
    sel = [r for r in rows.values() if r["kernel"] == kname and r["batch"] == batch]
    if not sel or sel[0][key] is None:
        return None
    return sum(r[key] * r["per_forward"] for r in sel)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--change", default=HERE)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--worker")
    ap.add_argument("--out")
    ap.add_argument("--hash", type=int, default=0)
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, a.out, bool(a.hash))
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
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name],
                        "--out", path, "--hash", str(int(not runs[name]))], check=True)
        with open(path) as f:
            runs[name].append(json.load(f))
        print(f"[turn {i}] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    card = runs["change"][0]["card"]
    summary = dict(card=card, order=order, kernels={}, split={}, serving={}, bits={})
    for kname in REDESIGNED:
        for batch in (1, 4):
            for key in ("ms", "device_ms", "library_ms"):
                vals = {n: [_per_forward(r["rows"], kname, batch, key) for r in runs[n]]
                        for n in runs}
                if all(v is not None for vs in vals.values() for v in vs):
                    summary["kernels"][f"{kname} bs{batch} {key}"] = vals
    for n in runs:
        summary["split"][n] = [r["split_bs4_512"] for r in runs[n]]
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
        print(f"[ab] {k:40s} parent {[round(v, 4) for v in vals['parent']]}  "
              f"change {[round(v, 4) for v in vals['change']]}")
    for n in runs:
        for r in summary["split"][n]:
            print(f"[ab split bs4 512^2] {n}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r.items() if k != "calls") + f" ms ({r['calls']} calls)")
        for r in summary["serving"][n]:
            print(f"[ab serving] {n}: " + ", ".join(
                f"{s}^2 bs1 {d['bs1_slices_per_s']:.3f} bs4 {d['bs4_slices_per_s']:.3f}"
                for s, d in r.items()) + " slices/s")
    print(f"[ab bits] {len(same)} of {summary['bits']['compared']} untouched-kernel outputs "
          f"identical; differ: {differ[:10]}")
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
