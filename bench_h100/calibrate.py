"""Readings that the limits of a cell's correctness check are set from, in
one process (the kernels build once):

- the program's numbers on each of ``--seeds`` after a short window;
- the control's on each of ``--control-seeds``: the reference in the
  program's place, at the next precision below each that the
  configuration states (fp8 products for a bf16 trunk, TF32 for float32);
- each planted fault's (``lib/faults.py``) on each of ``--fault-seeds``.

    python3 bench_h100/calibrate.py --workload fd512-serve-bs4 --seeds 1,2,3 \\
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 3 --out calibrate.jsonl

One JSON line per reading on standard output and in ``--out``; then, per
number, the largest program reading and the smallest control and fault
readings.
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
import contextlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402

from bench_h100.lib import build, faults, manifest  # noqa: E402


def reading(root, workload, seed, seconds, device, control=False, fault=None) -> dict:
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    config = manifest.config(root, man, cell)
    traffic = manifest.traffic(root, cell["traffic"])
    env.fp32_means_fp32()
    plant = faults.FAULTS[traffic["kind"]][fault] if fault else contextlib.nullcontext
    t = time.perf_counter()
    with plant():
        driver = manifest.module(root, "drivers", traffic["kind"]).Cell(config, traffic, seed,
                                                                         device)
        driver.setup()
        t0, n = time.perf_counter(), 0
        while n == 0 or time.perf_counter() - t0 < seconds:
            driver.run_once(n)
            n += 1
    driver.release()
    numbers = driver.check(random.Random(seed), control=control)
    build.free(device)
    details = getattr(driver, "details", {})
    kind = "control" if control else fault or "program"
    return dict(workload=workload, seed=seed, kind=kind, units=n,
                seconds=time.perf_counter() - t, numbers=numbers,
                details={k: v for k, v in details.items() if k != "left_out"},
                left_out=len(details.get("left_out", ())))


def summary(rows) -> dict:
    out = {}
    for r in rows:
        for name, v in r["numbers"].items():
            s = out.setdefault(name, {})
            key = "lower" if r["kind"] == "program" else r["kind"]
            pick = max if r["kind"] == "program" else min
            s[key] = v if key not in s else pick(s[key], v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="", help="comma-separated; default: every fault of the "
                   "cell's kind")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    man = manifest.load(ROOT)
    kind = manifest.traffic(ROOT, manifest.cell(man, a.workload)["traffic"])["kind"]
    jobs = [(s, False, None) for s in seeds(a.seeds)]
    jobs += [(s, True, None) for s in seeds(a.control_seeds)]
    chosen = [f for f in a.faults.split(",") if f] or list(faults.FAULTS[kind])
    jobs += [(s, False, f) for s in seeds(a.fault_seeds) for f in chosen]
    rows = []
    sink = open(a.out, "a") if a.out else None
    try:
        for seed, control, fault in jobs:
            r = reading(ROOT, a.workload, seed, a.seconds, a.device, control, fault)
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        line = json.dumps({"workload": a.workload, "summary": summary(rows)})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
