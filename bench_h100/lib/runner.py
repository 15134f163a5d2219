"""One run of one cell: set-up, the measured window, with ``trace`` the spans
and the profiler's windows, then the correctness check and the result line.

The cell's driver (``drivers/<kind>.py``, named by its traffic mix) builds
the system under test from the configuration and the seed, runs one unit of
work (a request, a train step) per ``run_once`` call, and compares what the
timed path produced with the plain reference after the window.
"""

from __future__ import annotations

import json
import random
import sys
import time
import types

from . import compare, env, manifest, spans, trace


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


def _line(stream, text):
    print(text, file=stream, flush=True)


def _per_layer(root, man, workload, ctx) -> dict:
    out = {}
    for m in manifest.per_layer(man, workload):
        value = manifest.module(root, "metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace_on: bool, root: str, device="cuda",
        t_start=None, out=sys.stdout, err=sys.stderr) -> dict:
    """Runs the cell of the checkout at ``root`` and prints its result line;
    returns the result.  On ``device="cuda"`` a missing card raises
    :class:`NoDevice` before any work.  ``t_start``: the process's start on
    the host clock."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    cuda = device != "cpu"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoDevice(f"{workload} needs {cell['chips']} CUDA card(s); torch sees {seen}")
    config = manifest.config(root, man, cell)
    traffic = manifest.traffic(root, cell["traffic"])
    limits = manifest.checks(root, workload)["limits"]
    env.fp32_means_fp32()
    driver = manifest.module(root, "drivers", traffic["kind"]).Cell(config, traffic, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t_start

    records = []  # (seconds, slices) of each unit of work
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        slices = driver.run_once(len(records))
        records.append((time.perf_counter() - t, slices))
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    laps = ", ".join(f"{k} {v:.3f}" for k, v in driver.timings.items())
    _line(err, f"setup_s {setup_s:.3f} ({laps}); window_s {window_s:.3f} over {len(records)} units")

    result = {"correct": False, "attempted": len(records),
              "failed": driver.failures(len(records)), "metrics": {}}
    if trace_on:
        ctx = types.SimpleNamespace(
            config=config, traffic=traffic, cuda=cuda,
            work=lambda name: manifest.module(root, "work", name),
            window=dict(units=len(records), seconds=window_s,
                        slices=sum(r[1] for r in records)))
        n = traffic["trace_units"]
        with spans.Spans(driver.model, ("SS2D", "MambaBlock"), backward=driver.trains) as s:
            for i in range(n):
                driver.run_once(len(records) + i)
        ctx.spans, ctx.span_units = s.records, n
        ops = ("aten::convolution", "aten::convolution_backward")
        with trace.Profile(cuda, host=True) as prof:
            for i in range(n):
                driver.run_once(len(records) + n + i)
        ctx.trace = host = prof.summary(ops)
        if cuda:  # busy time, kernels and top operations from a device-only window
            with trace.Profile(cuda, host=False) as prof:
                for i in range(n):
                    driver.run_once(len(records) + 2 * n + i)
            ctx.trace = dict(prof.summary(), op_device_s=host["op_device_s"],
                             idle_gaps=host["idle_gaps"])
        ctx.trace_units = n
        result["metrics"] = _per_layer(root, man, workload, ctx)
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
        busy_window = dict(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
    else:
        e2e = driver.end_to_end(records, window_s)
        e2e["setup_s"] = setup_s
        for m in manifest.end_to_end(man, workload):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        busy_window = {}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak), **busy_window}
    result["device"] = device_info
    if cuda:
        result["card"] = env.power_limit()

    driver.release()
    t = time.perf_counter()
    numbers = driver.check(random.Random(seed))
    _line(err, f"check_s {time.perf_counter() - t:.3f}")
    rows = compare.judge(numbers, limits)
    result["correct"] = all(ok for *_, ok in rows)
    found = env.forbidden_modules()
    if found:
        _line(err, "forbidden modules loaded: " + ", ".join(found))
        raise SystemExit(3)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in rows}
    for name, value, limit, ok in rows:
        _line(err, f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}")
    _line(out, json.dumps(result))
    return result
