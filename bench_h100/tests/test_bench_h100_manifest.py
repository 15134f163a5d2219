"""The manifest against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from bench_h100.lib import manifest

from tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return manifest.load(REPO)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    assert set(man) == KEYS
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32 and all(line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51


def test_time_budget(man):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (man["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_entries(man):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
        for e in man[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"])
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128
    for c in man["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert all(w["chips"] in (1, 4) for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and line(w["why"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e


def test_every_cell_reports_enough(man):
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e2e = {m["name"] for m in manifest.end_to_end(man, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer(man, w)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_layers_named_alike(man):
    by_layer = {}
    for m in man["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_found_by_name(man):
    """Every cell's configuration, traffic, driver and check limits, every
    metric's reader, every work module: found from the names alone."""
    for w in man["workloads"]:
        config = manifest.config(REPO, man, w)
        assert config["name"] == w["config"] and config["reduced"] == []
        traffic = manifest.traffic(REPO, w["traffic"])
        driver = manifest.module(REPO, "drivers", traffic["kind"])
        for fn in ("setup", "run_once", "end_to_end", "release", "check"):
            assert callable(getattr(driver.Cell, fn))
        limits = manifest.checks(REPO, w["name"])["limits"]
        assert limits and all(v > 0 for v in limits.values())
    for m in man["per_layer"]:
        assert callable(manifest.module(REPO, "metrics", m["name"]).read)
    for name in os.listdir(os.path.join(REPO, "bench_h100", "work")):
        if name.endswith(".py"):
            manifest.module(REPO, "work", name[:-3])


def test_file_names_are_names():
    for dirpath, _, files in os.walk(os.path.join(REPO, "bench_h100")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def test_configs_as_run(man):
    """The configuration files hold the published widths, nothing cut."""
    from founddiff_tpu_torch.config import Config

    default = Config()
    for c in man["configs"]:
        config = manifest.read_json(REPO, c["file"])
        m = config["program"]["model"]
        assert (m["dim"], tuple(m["dim_mults"])) == (default.model.dim, default.model.dim_mults)
        assert config["program"]["diffusion"]["image_size"] == 512
        assert config.get("tower", {}) == {}
    text = json.dumps(man)
    assert "founddiff_tpu/" not in text
