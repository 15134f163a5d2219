"""A checkout root in a temporary directory holding tiny cells of both
families, added as files only: the harness's own drivers, readers and work
modules copied in, and new configuration, traffic, check and manifest
files.  The CPU tests run whole cells there."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOWER = {"backbone_resolution": 64, "embed_dim": 32, "vision_layers": [1, 1, 1, 1],
         "vision_width": 8, "transformer_width": 16, "transformer_layers": 1,
         "transformer_heads": 2}
# each tiny cell is held to the limits of the full-size cell it stands in for
STAND_IN = {"tiny-serve": "fd512-serve-bs4", "tiny-train": "fd512-train-fp32",
            "tiny-vanilla-train": "vanilla512-train-fp32"}


def tiny_config(name: str, family: str) -> dict:
    with open(os.path.join(REPO, "bench_h100", "configs", family_file(family))) as f:
        c = json.load(f)
    c["name"] = name
    c["program"]["model"].update(dim=8, dim_mults=[1, 2])
    c["program"]["diffusion"]["image_size"] = 32
    if family == "founddiff":
        c["tower"] = dict(TOWER)
    return c


def family_file(family: str) -> str:
    return {"founddiff": "founddiff-512.json", "vanilla": "vanilla-ddpm-512.json"}[family]


def make_root(tmp) -> str:
    """The root, with cells tiny-serve, tiny-train and tiny-vanilla-train."""
    root = str(tmp)
    bench = os.path.join(root, "bench_h100")
    for sub in ("drivers", "metrics", "work", "traffic"):
        shutil.copytree(os.path.join(REPO, "bench_h100", sub), os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "checks"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        man = json.load(f)
    cells = [("tiny-serve", "tiny-fd", "founddiff", "serve-tiny", "serve"),
             ("tiny-train", "tiny-fd", "founddiff", "train-tiny", "train"),
             ("tiny-vanilla-train", "tiny-vanilla", "vanilla", "train-tiny", "train")]
    man["configs"], man["workloads"] = [], []
    for cell, config, family, traffic, kind in cells:
        if not any(c["name"] == config for c in man["configs"]):
            path = f"bench_h100/configs/{config}.json"
            with open(os.path.join(root, path), "w") as f:
                json.dump(tiny_config(config, family), f)
            man["configs"].append({"name": config, "source": "https://github.com/hao1635/FoundDiff",
                                   "file": path, "reduced": [], "why": "tiny"})
        man["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                 "why": "tiny"})
        shutil.copy(os.path.join(REPO, "bench_h100", "checks", STAND_IN[cell] + ".json"),
                    os.path.join(bench, "checks", cell + ".json"))
    serve = {"kind": "serve_closed", "batch": 2, "pool": 3, "warmup": 1,
             "check_requests": 2, "trace_units": 1}
    train = {"kind": "train_steps", "pool": 5, "check_steps": 3, "trace_units": 1}
    for name, t in (("serve-tiny", serve), ("train-tiny", train)):
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    stand_in = {full: tiny for tiny, full in STAND_IN.items()}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [stand_in[w] for w in m["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
