"""``BENCHMARK.json`` and the files it names, found by name.

Everything one cell needs lies in files of its own under ``bench_h100/``:
the configuration (``configs/<config>.json``, named by the manifest's
``file``), the traffic mix (``traffic/<traffic>.json``), whose ``kind``
names its driver (``drivers/<kind>.py``), the limits of the correctness
check (``checks/<workload>.json``), one reader per per-layer metric
(``metrics/<metric>.py``) and one module per unit of work
(``work/<unit>.py``).  Nothing here lists them: a cell, a configuration, a
traffic mix or a metric is added by adding its files.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = "bench_h100"


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(root: str, manifest: dict, workload: dict) -> dict:
    for c in manifest["configs"]:
        if c["name"] == workload["config"]:
            return read_json(root, c["file"])
    raise KeyError(f"no config {workload['config']!r} in BENCHMARK.json")


def traffic(root: str, name: str) -> dict:
    return read_json(root, BENCH, "traffic", name + ".json")


def checks(root: str, workload: str) -> dict:
    return read_json(root, BENCH, "checks", workload + ".json")


def module(root: str, kind: str, name: str):
    """``bench_h100/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, BENCH, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} module {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"{BENCH}_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(manifest: dict, workload: str) -> list:
    return [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer(manifest: dict, workload: str) -> list:
    """The per-layer metrics a ``--trace 1`` run of ``workload`` reports: those
    that list it, and those without a list that move one of its
    end-to-end metrics."""
    mine = {m["name"] for m in end_to_end(manifest, workload)}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in mine)]
