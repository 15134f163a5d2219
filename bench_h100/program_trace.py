"""The program's spans and launch counters in one cell, beside the harness's
hooks: one JSON line.

    python3 bench_h100/program_trace.py --workload <name> --seed <n> [--out FILE]

from the root of a checkout.  Sets the cell up as ``run.py`` does, then runs
the traffic's ``trace_units`` units (in training at least the
``ema_update_every`` steps that hold one EMA blend) under the
harness's forward hooks on ``MambaBlock`` and ``SS2D`` (``lib/spans.py``),
then the two device-only windows of ``lib/program.py``: spans off, spans on.
The line holds the per-layer numbers of ``program.metrics``, the spans'
device or host ms and calls per unit by name, the launches per unit by C entry, the
top idle stretches by span, the hooks' ms per UNet forward beside the
spans', what recording costs (unit time on against off, also one line on
standard error) and what a span costs with recording off, on this host's
CPU.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100.lib import env  # noqa: E402

env.set_caches(ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from bench_h100.lib import manifest, program, spans  # noqa: E402


def _off_span_us(calls: int = 200000) -> float:
    """µs a ``span`` costs with recording off, over an empty loop's."""
    from founddiff_tpu_torch.utils import trace as ptrace

    t = time.perf_counter()
    for _ in range(calls):
        with ptrace.span("kernel.off"):
            pass
    spent = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(calls):
        pass
    return 1e6 * (spent - (time.perf_counter() - t)) / calls


def _per_forward(records, cls, forwards):
    calls = [s for phase, s, _ in records.get(cls, []) if phase == "forward"]
    return 1e3 * sum(calls) / forwards if calls else None


def reading(root, workload, seed, device="cuda") -> dict:
    import torch

    man = manifest.load(root)
    entry = manifest.cell(man, workload)
    config = manifest.config(root, man, entry)
    traffic = manifest.traffic(root, entry["traffic"])
    cuda = device != "cpu"
    env.fp32_means_fp32()
    cell = manifest.module(root, "drivers", traffic["kind"]).Cell(config, traffic, seed, device)
    cell.setup()
    n = traffic["trace_units"]
    if cell.trains:
        n = max(n, config["program"]["train"].get("ema_update_every", 10))
    per_unit = config["program"]["diffusion"]["sampling_timesteps"] if not cell.trains else \
        config["program"]["train"]["gradient_accumulate_every"]
    with spans.Spans(cell.model, ("SS2D", "MambaBlock"), backward=False) as hooks:
        for i in range(n):
            cell.run_once(i)
    got = program.window(cell, n, n, cuda)
    if got is None:
        raise SystemExit("the program under test records no spans")
    forwards = n * per_unit
    by_name, calls = {}, {}
    for s in got["spans"]:
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + s["ms"] / n
        calls[s["name"]] = calls.get(s["name"], 0) + 1 / n
    idle = sorted(got.get("idle_by_span", {}).items(), key=lambda kv: -kv[1])
    out = dict(
        workload=workload, seed=seed, units=n,
        device=torch.cuda.get_device_name(0) if cuda else "cpu",
        card=env.power_limit() if cuda else "cpu",
        metrics=program.metrics(got, cell.trains),
        span_ms_per_unit=by_name, span_calls_per_unit=calls,
        launches_per_unit={k: v / n for k, v in sorted(got["counters"].items())},
        kernels_per_unit=got.get("kernels"),
        idle_by_span=[[k, v] for k, v in idle[:10]],
        idle_s=sum(v for _, v in idle), window_s=got["window_s"], busy_s=got.get("busy_s"),
        hooks_ms_per_forward={c: _per_forward(hooks.records, c, forwards)
                              for c in ("MambaBlock", "SS2D")},
        spans_ms_per_forward={c: by_name.get(name, 0.0) * n / forwards
                              for c, name in (("MambaBlock", "mamba_block"), ("SS2D", "ss2d"))},
        unit_s=got["unit_s"],
        on_cost_pct=100.0 * (got["unit_s"]["on"] / got["unit_s"]["off"] - 1.0),
        off_span_us=_off_span_us())
    if not cell.trains:
        request = by_name.get("serve.request")
        if request:
            out["tower_and_steps_pct_of_request"] = 100.0 * (
                by_name.get("tower", 0.0) + by_name.get("ddim.step", 0.0)) / request
    print(f"recording on {1e3 * got['unit_s']['on']:.3f} ms a unit against off "
          f"{1e3 * got['unit_s']['off']:.3f} ms ({out['on_cost_pct']:+.2f}%)", file=sys.stderr)
    cell.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    line = json.dumps(reading(ROOT, a.workload, a.seed))
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
