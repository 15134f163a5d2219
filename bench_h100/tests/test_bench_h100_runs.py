"""Whole runs of tiny cells on the CPU: cells added as files only in a
temporary checkout, the result line, the modules a run leaves loaded, the
planted faults and the control coming out as not correct."""

from __future__ import annotations

import io
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from bench_h100 import calibrate
from bench_h100.lib import compare, faults, manifest, runner

import tiny

CELLS = ("tiny-serve", "tiny-train", "tiny-vanilla-train")
SEED = 2 ** 31 + 1017  # past 32 signed bits: a seed may be larger than an int32


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, cell, trace=False, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    result = runner.run(cell, seed, 0.2, trace, root=root, device="cpu", out=out, err=err)
    return result, out.getvalue(), err.getvalue()


def test_cells_added_as_files_are_found(root):
    man = manifest.load(root)
    assert [w["name"] for w in man["workloads"]] == list(CELLS)
    assert manifest.config(root, man, man["workloads"][0])["program"]["model"]["dim"] == 8


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_prints_the_contract_line(root, cell, trace):
    result, out, err = _run(root, cell, trace)
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    assert list(last)[:3] == ["correct", "attempted", "failed"] and list(last)[-1] == "checks"
    assert last["correct"] is True and last["attempted"] >= 1 and last["failed"] == 0
    man = manifest.load(root)
    if trace:
        assert set(last["device"]) >= {"busy_s", "window_s"} and "breakdown" in last
    else:
        want = {m["name"] for m in manifest.end_to_end(man, cell)}
        assert set(last["metrics"]) == want
        assert all(v["value"] > 0 for v in last["metrics"].values())
    checks = last["checks"]
    assert checks and err.strip().splitlines()[-len(checks):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r} ok" for k, v in checks.items()]


def _serve_driver(root, seed):
    man = manifest.load(root)
    cell = manifest.cell(man, "tiny-serve")
    traffic = manifest.traffic(root, cell["traffic"])
    d = manifest.module(root, "drivers", traffic["kind"]).Cell(
        manifest.config(root, man, cell), traffic, seed, "cpu")
    d.setup()
    return d


def test_same_seed_same_inputs(root):
    a, b, c = (_serve_driver(root, s) for s in (SEED, SEED, SEED + 1))
    assert torch.equal(a.inputs, b.inputs) and torch.equal(a.noise, b.noise)
    assert all(torch.equal(a.state[k], b.state[k]) for k in a.state)
    assert not torch.equal(a.inputs, c.inputs)
    assert any(not torch.equal(a.state[k], c.state[k]) for k in a.state)


def test_no_forbidden_module_after_a_run(root):
    code = ("import sys; sys.path.insert(0, %r); from bench_h100.lib import runner, env; "
            "runner.run('tiny-serve', 7, 0.1, False, root=%r, device='cpu'); "
            "print('FOUND', env.forbidden_modules())" % (tiny.REPO, root))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_no_card_no_result():
    code = ("import sys; sys.argv = ['run.py', '--workload', 'fd512-serve-bs4', '--seed', '1', "
            "'--seconds', '1']; sys.path.insert(0, %r); import runpy; "
            "runpy.run_path(%r, run_name='__main__')" % (tiny.REPO, os.path.join(
                tiny.REPO, "bench_h100", "run.py")))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_alone_without_the_program_no_result(tmp_path):
    """A checkout with only BENCHMARK.json and bench_h100/ cannot run."""
    import shutil

    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.REPO, "bench_h100"), tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = tiny.make_root(tmp_path / "tiny_only")
    code = ("import sys; sys.path.insert(0, %r); from bench_h100.lib import runner; "
            "runner.run('tiny-serve', 7, 0.1, False, root=%r, device='cpu')"
            % (str(tmp_path), root))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode != 0 and "founddiff_tpu_torch" in out.stderr
    assert '"correct"' not in out.stdout


FAULT_CASES = [("tiny-serve", f) for f in faults.FAULTS["serve_closed"]] + \
    [(c, f) for c in ("tiny-train", "tiny-vanilla-train") for f in faults.FAULTS["train_steps"]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(root, cell, fault):
    kind = "serve_closed" if cell == "tiny-serve" else "train_steps"
    with faults.FAULTS[kind][fault]():
        result, _, err = _run(root, cell)
    assert result["correct"] is False
    assert "FAILED" in err


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(root, cell):
    """The reference at the next precision below the configuration's, in the
    program's place, fails the limits of the full-size cell it stands for."""
    r = calibrate.reading(root, cell, 11, 0.1, "cpu", control=True)
    assert r["kind"] == "control"
    limits = manifest.checks(tiny.REPO, tiny.STAND_IN[cell])["limits"]
    rows = compare.judge(r["numbers"], limits)
    assert not all(ok for *_, ok in rows), rows


def test_check_sample_is_drawn_from_the_seed(root):
    man = manifest.load(root)
    cell = manifest.cell(man, "tiny-serve")
    traffic = manifest.traffic(root, cell["traffic"])
    picks = [random.Random(s).sample(range(20), traffic["check_requests"]) for s in (1, 1, 2)]
    assert picks[0] == picks[1] != picks[2]
