#!/usr/bin/env python3
"""Time two trees of the PyTorch/CUDA port in turns on one card, and compare
the bits of the kernels the newer tree leaves alone.

    python scripts/port_ab.py --parent DIR [--change DIR] [--turns 2]

Each DIR holds a checkout of the repository (for example ``git archive`` of
a commit unpacked into a directory that git ignores); ``--change`` defaults
to the tree this script lies in.  The trees run in turns, parent, change,
change, parent, ... cut to ``--turns`` turns a tree (:func:`turn_order`:
``--turns 1`` is parent, change; ``--turns 2`` parent, change, change,
parent), each turn a worker process started from its
tree, so that each imports its own ``founddiff_tpu_torch`` and
``chip_smoke.py`` and builds its own kernels.  A worker measures, on inputs
made from a seed here (the same in both trees):

- ``kernels``: the two kernels redesigned last, each call timed alone:
  ``flash_bwd_dq`` and ``flash_bwd_dkv`` at the vanilla bottleneck
  (chip_smoke's ``flash_case``, the training microbatch of 2, L 4,096) in
  fp32 and bf16, beside the backward of ``scaled_dot_product_attention``
  (dq, dk and dv in one call): event time (CUDA events, median of 7 after 2
  warm-ups) and, from ``torch.profiler`` over 10 calls, device time and by
  kernel the device time and launches of one call (``port`` where the name
  is a ``__global__`` function of the tree's sources, else ``torch``); and
  their sums over a unit: an fp32 train step (two calls, one per
  microbatch) or one bf16 call;
- ``vanilla``: UNet forwards/s of the vanilla path (``Config()`` with
  ``original_ddim_ddpm``, 512^2, fp32) at bs1 and bs4 on each route (median
  of 5 after a warm-up, host clock around work that ends in a synchronize);
- ``train``: the fp32 train step of ``Config()`` at 512^2 and 360^2
  (chip_smoke's ``train_full_width`` without its bf16 steps: a warm-up
  step, then the median of 3), with its launch counts checked;
- ``serving``: DDIM-2 serving of ``Config()`` in bf16 at 512^2 and 360^2,
  and at 512^2 with both opt-in routes on (chip_smoke's ``ROUTES``, as in
  its phase 10): slices/s at bs1 (median of 4 requests) and bs4 (median of
  2 batches).

In its first turn each tree also hashes (``hash``: sha256) the outputs of
every phase-2 case of the kernels listed in ``UNTOUCHED``, fp32 and bf16, at
inputs seeded by the case's name, so that the two trees' bits can be
compared.  ``--parts`` picks what a worker measures (all by default).
Needs one CUDA card.  Writes ``chiprun_out/port_ab.json`` under the
working directory and prints a table.  ``--worker DIR --out FILE`` runs one
tree alone (DIR an absolute path).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNTOUCHED = ("ss2d_image_block", "attn_block", "layer_norm_modulated", "scan_forward",
             "scan_backward", "scan_image_forward", "layer_norm", "gn_stats", "gn_apply",
             "flash_fwd", "ss2d_mamba_block", "scan_fused_forward", "merge_ln_gate")
PARTS = ("hash", "kernels", "vanilla", "train", "serving")
# the modules of the kernels whose launches a train step counts
WRAPPED = (("ss2d_image_block", "ss2d_block"), ("attn_block", "attn_block"),
           ("layer_norm_modulated", "norm"), ("scan_forward", "scan"),
           ("scan_backward", "scan"), ("scan_image_forward", "scan"),
           ("flash_fwd", "flash_attention"), ("flash_bwd_dq", "flash_attention"),
           ("flash_bwd_dkv", "flash_attention"),
           ("gn_stats", "groupnorm"), ("gn_apply", "groupnorm"),
           ("ss2d_mamba_block", "experimental_unified"), ("scan_fused_forward", "scan"),
           ("layer_norm", "norm"), ("merge_ln_gate", "ss2d_fused"))
GN_ROUTE = {"FOUNDDIFF_GN": "pallas"}


def _ops():
    """kernel name -> wrapper, as chip_smoke.py calls them in phase 2 (the
    kernels of UNTOUCHED)."""
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
        "scan_image_forward": scan_mod.scan_image_forward,
        "flash_fwd": flash_mod.flash_fwd, "ss2d_mamba_block": unified_mod.ss2d_mamba_block,
        "gn_stats": gn_mod.gn_stats, "gn_apply": gn_mod.gn_apply,
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


@contextlib.contextmanager
def _env(values):
    """``os.environ`` with ``values`` set (None: unset) for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _serve(cs, size: int, card: str, routes: bool = False):
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

    with _env(cs.ROUTES if routes else {}):
        request(x[:1], 0)
        request(x, 0)
        bs1 = [request(x[i:i + 1], 100 + i) for i in range(4)]
        bs4 = [request(x, 200 + i) for i in range(2)]
    del model, sampler
    torch.cuda.empty_cache()
    return dict(bs1_slices_per_s=1 / statistics.median(bs1),
                bs4_slices_per_s=4 / statistics.median(bs4), bs1_request_s=bs1, bs4_batch_s=bs4)


def _kernel_name(key: str) -> str:
    """A profiler kernel name without namespaces or parameters, with its
    template arguments, which tell the launches of one template apart."""
    for drop in ("void ", "(anonymous namespace)::", "fd::"):
        key = key.replace(drop, "")
    return key.split("(")[0]


def _port_names(tree: str) -> set:
    """The ``__global__`` functions of the tree's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(tree, "founddiff_tpu_torch", "csrc", "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", f.read()))
    return names


def _is_port(name: str, port_names: set) -> bool:
    """A kernel of the port: in namespace fd or a file's anonymous namespace,
    and one of the tree's ``__global__`` functions (PyTorch has
    anonymous-namespace kernels too: ``softmax_warp_forward``), the rule of
    chip_smoke's "port kernels" group."""
    return (name.startswith(("void fd::", "void (anonymous namespace)::", "fd::",
                             "(anonymous namespace)::"))
            and _kernel_name(name).split("<")[0] in port_names)


def _device_split(fn, port_names: set, n: int = 10):
    """Device ms and launches of one call by kernel, from ``torch.profiler``
    over n calls (the rest of its event-timed time is the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if events:
            break
    # a kernel's launches a call rounded, times its mean: the profiler now
    # and then drops an event
    ms, launches = {}, {}
    for e in events:
        k = ("port " if _is_port(e.key, port_names) else "torch ") + _kernel_name(e.key)
        per_call = max(1, round(e.count / n))
        ms[k] = ms.get(k, 0.0) + e.self_device_time_total / 1e3 / e.count * per_call
        launches[k] = launches.get(k, 0) + per_call
    return ms, launches


def _unit_calls(cs):
    """(unit, case label, calls per unit, zero-argument call, library call)
    of the two kernels redesigned last: ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` at the vanilla bottleneck and the training microbatch,
    per fp32 train step (two calls, one per microbatch) and per bf16 call,
    beside SDPA's backward."""
    import torch

    from founddiff_tpu_torch.ops import flash_attention as flash_mod

    dev = torch.device("cuda")
    B, L = cs.TRAIN_BATCH, cs.FLASH_L
    for kname in cs.FLASH_BWD:
        fn = getattr(flash_mod, kname)
        for dtype, per, n in ((torch.float32, "fp32 step", 2), (torch.bfloat16, "bf16 call", 1)):
            unit = f"{kname} {per}"
            label = f"{unit} B{B} L={L}"
            args, _, _, _, _, library = cs.flash_case(kname, B, L, L, dtype, _gen(label), dev)
            yield unit, label, n, lambda args=args, fn=fn: fn(*args), library


def _kernel_rows(cs, tree: str) -> dict:
    """Event ms, device ms, and device ms and launches by kernel of one call
    of each of _unit_calls, with the library call's event ms beside it."""
    import torch

    rows, port_names = {}, _port_names(tree)
    for unit, label, n, fn, library in _unit_calls(cs):
        split, launches = _device_split(fn, port_names)
        rows[label] = dict(unit=unit, per_unit=n, ms=cs.cuda_ms(fn),
                           device_ms=sum(split.values()), split=split, launches=launches,
                           library_ms=None if library is None else cs.cuda_ms(library))
        del fn, library
        torch.cuda.empty_cache()
    return rows


def _vanilla(cs) -> dict:
    """Vanilla UNet forwards/s at bs1 and bs4 on each GroupNorm route."""
    import torch
    from founddiff_tpu_torch.factory import build

    cfg = cs.vanilla_config()
    _, model = build(cfg, device="cuda", seed=0)
    S = cfg.diffusion.image_size
    out = {}
    for route, env in (("default", {"FOUNDDIFF_GN": None}), ("kernels", GN_ROUTE)):
        with _env(env):
            for B in (1, 4):
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
                out[f"{route} bs{B}"] = dict(forwards_per_s=1.0 / statistics.median(times),
                                             s=times)
    del model
    torch.cuda.empty_cache()
    return out


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
    out_path = os.path.abspath(out_path)  # before the chdir into the tree
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from founddiff_tpu_torch.ops import _build

    for k in cs.ROUTES:  # the default routes, but where a part sets its own
        os.environ.pop(k, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    built = _build.build_all()
    ops = _ops()
    dev = torch.device("cuda")
    rec = dict(tree=tree, card=card, build_s=built["seconds"], hashes={}, rows={}, vanilla={},
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
        rec["rows"] = _kernel_rows(cs, tree)
        _print_units(rec["rows"], card, os.path.basename(tree))
    if "vanilla" in parts:
        rec["vanilla"] = _vanilla(cs)
    if "train" in parts:
        rec["train"] = _train(cs, card)
    if "serving" in parts:
        rec["serving"] = {str(size): _serve(cs, size, card) for size in (512, cs.ODD_SIZE)}
        rec["serving"]["512 routes"] = _serve(cs, 512, card, routes=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def _units(rows, field):
    """A row field summed over the calls of each unit; for a dict field
    (split, launches), by kernel within each unit."""
    out = {}
    for r in rows.values():
        if isinstance(r[field], dict):
            d = out.setdefault(r["unit"], {})
            for k, v in r[field].items():
                d[k] = d.get(k, 0.0) + v * r["per_unit"]
        elif r[field] is not None:
            out[r["unit"]] = out.get(r["unit"], 0.0) + r[field] * r["per_unit"]
    return out


def _print_units(rows, card, tag) -> None:
    """Each unit's event, device and library ms, its device ms and launches
    by kernel, and each call's device split."""
    ms, dev, lib = _units(rows, "ms"), _units(rows, "device_ms"), _units(rows, "library_ms")
    split, launches = _units(rows, "split"), _units(rows, "launches")
    for u in ms:
        extra = f", library {lib[u]:.4f}" if u in lib else ""
        print(f"[ab unit] {tag} {u}: event {ms[u]:.4f} ms, device {dev[u]:.4f}"
              f"{extra} [{card}]")
        print(f"[ab unit split] {tag} {u}: " + ", ".join(
            f"{k} {v:.4f} ms in {launches[u][k]:.0f}"
            for k, v in sorted(split[u].items(), key=lambda x: -x[1])))
    for label, r in rows.items():
        print(f"[ab call] {tag} {label}: event {r['ms']:.4f} ms, device {r['device_ms']:.4f}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(r["split"].items(),
                                                            key=lambda x: -x[1])))


def turn_order(turns: int) -> list:
    """The trees' turns: parent, change, change, parent, ... cut to ``turns``
    turns of each tree, so that each tree runs at least once (the ``hash``
    part needs one turn a side)."""
    if turns < 1:
        raise ValueError(f"--turns must be at least 1, not {turns}")
    pattern = ("parent", "change", "change", "parent")
    return [pattern[i % 4] for i in range(2 * turns)]


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
    order = turn_order(a.turns)
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
    summary = dict(card=card, order=order, units={}, split={}, vanilla={}, train={},
                   serving={}, bits={})
    for key in ("ms", "device_ms"):
        for n in runs:
            for r in runs[n]:
                for u, v in _units(r["rows"], key).items():
                    summary["units"].setdefault(f"{u} {key}", {"parent": [], "change": []})
                    summary["units"][f"{u} {key}"][n].append(v)
    for n in runs:
        summary["split"][n] = [_units(r["rows"], "split") for r in runs[n] if r["rows"]]
        summary["vanilla"][n] = [r["vanilla"] for r in runs[n] if r["vanilla"]]
        summary["train"][n] = [r["train"] for r in runs[n] if r["train"]]
        summary["serving"][n] = [{s: {k: v for k, v in d.items() if k.endswith("per_s")}
                                  for s, d in r["serving"].items()}
                                 for r in runs[n] if r["serving"]]
    hp, hc = runs["parent"][0]["hashes"], runs["change"][0]["hashes"]
    same = sorted(k for k in hp if hc.get(k) == hp[k])
    differ = sorted(k for k in hp if k in hc and hc[k] != hp[k])
    summary["bits"] = dict(compared=len(set(hp) & set(hc)), identical=len(same), differ=differ,
                           only_parent=sorted(set(hp) - set(hc)))
    with open(os.path.join(os.getcwd(), "chiprun_out", "port_ab.json"), "w") as f:
        json.dump(dict(summary=summary, runs=runs), f, indent=1)
    print(card)
    for k, vals in summary["units"].items():
        print(f"[ab] {k}: parent {[round(v, 4) for v in vals['parent']]}  "
              f"change {[round(v, 4) for v in vals['change']]}")
    for n in runs:
        for turn in summary["split"][n]:
            for u, d in turn.items():
                print(f"[ab split] {n} {u}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(d.items(), key=lambda x: -x[1])))
        for r in summary["vanilla"][n]:
            print(f"[ab vanilla forwards/s] {n}: " + ", ".join(
                f"{k} {d['forwards_per_s']:.3f}" for k, d in r.items()))
        for r in summary["train"][n]:
            print(f"[ab train fp32 step] {n}: " + ", ".join(
                f"{s}^2 {t:.4f} s" for s, t in r.items()))
        for r in summary["serving"][n]:
            print(f"[ab serving] {n}: " + ", ".join(
                f"{s}: bs1 {d['bs1_slices_per_s']:.3f} bs4 {d['bs4_slices_per_s']:.3f}"
                for s, d in r.items()) + " slices/s")
    print(f"[ab bits] {len(same)} of {summary['bits']['compared']} untouched-kernel outputs "
          f"identical; differ: {differ[:10]}")
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
