"""The program's spans read by ``lib/program.py`` and ``program_trace.py`` on
the CPU: idle stretches put down to the innermost open span, a tiny serving
and train cell's window and its numbers, the tool's line, and a program
without spans giving nothing."""

from __future__ import annotations

import sys

import pytest

from bench_h100 import program_trace
from bench_h100.lib import manifest, program

import tiny

SEED = 2 ** 31 + 29


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def _cell(root, cell):
    man = manifest.load(root)
    w = manifest.cell(man, cell)
    traffic = manifest.traffic(root, w["traffic"])
    d = manifest.module(root, "drivers", traffic["kind"]).Cell(
        manifest.config(root, man, w), traffic, SEED, "cpu")
    d.setup()
    return d


def _span(name, start, end):
    return dict(name=name, start_ns=start, end_ns=end)


def test_idle_by_span():
    """Window [0, 100): device busy at [10, 20) and [50, 60); the request
    span [5, 95) holds a step [15, 55) holding a kernel wrapper [20, 30)."""
    spans = [_span("serve.request", 5, 95), _span("ddim.step", 15, 55),
             _span("kernel.ln_forward", 20, 30)]
    device = [(10, 20, "a"), (50, 60, "b"), (52, 58, "c")]
    got = program.idle_by_span(device, spans, (0, 100))
    # idle [0, 10) middle 5: the request; [20, 50) middle 35: the step;
    # [60, 100) middle 80: the request
    assert got == {"serve.request": (10 + 40) / 1e9, "ddim.step": 30 / 1e9}
    got = program.idle_by_span(device, spans[1:], (0, 100))
    assert got == {program.OUTSIDE: 50 / 1e9, "ddim.step": 30 / 1e9}
    assert sum(got.values()) == pytest.approx((100 - 20) / 1e9)
    got = program.idle_by_span(device, [_span("kernel.x", 0, 100)], (0, 100))
    assert program.metrics(dict(units=1, spans=[], counters={}, idle_by_span=got,
                                window_s=100 / 1e9), trains=False) == {
        "wrapper_idle_pct.serve": pytest.approx(80.0)}


@pytest.mark.parametrize("cell,want", [
    ("tiny-serve", {"tower_ms.serve", "ddim_step_ms.serve"}),
    ("tiny-train", {"update_ms_per_step.train", "draw_host_ms_per_step.train"})])
def test_window_on_the_cpu(root, cell, want):
    """On the CPU: the spans of every unit of the second window, host times
    for device spans, no launches, no idle put down (no device trace)."""
    d = _cell(root, cell)
    got = program.window(d, 0, 2, cuda=False)
    roots = [s for s in got["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["train.step" if d.trains else "serve.request"] * 2
    assert got["units"] == 2 and got["counters"] == {} and "idle_by_span" not in got
    assert got["unit_s"]["on"] > 0 and got["unit_s"]["off"] > 0
    numbers = program.metrics(got, d.trains)
    assert set(numbers) == want and all(v > 0 for v in numbers.values())


def test_program_trace_line(root):
    """The tool's reading of a tiny serving cell on the CPU: the spans'
    numbers, one ``serve.request`` a unit, the hooks and the spans per UNet
    forward side by side, no idle (no device trace)."""
    got = program_trace.reading(root, "tiny-serve", SEED, device="cpu")
    assert set(got["metrics"]) == {"tower_ms.serve", "ddim_step_ms.serve"}
    assert got["span_calls_per_unit"]["serve.request"] == 1 and got["idle_by_span"] == []
    assert got["span_calls_per_unit"]["ddim.step"] == 2
    assert all(got[k]["MambaBlock"] > 0 for k in ("hooks_ms_per_forward", "spans_ms_per_forward"))
    assert got["device"] == "cpu" and got["off_span_us"] < 50


def test_without_the_trace_module_nothing(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "founddiff_tpu_torch.utils.trace", None)
    assert program.window(object(), 0, 1, cuda=False) is None
