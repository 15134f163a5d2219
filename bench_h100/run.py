"""Runs one cell of the benchmark of ``founddiff_tpu_torch`` on the card, once.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then the compared numbers with
their limits under ``checks``, also the last lines of standard error.
Exits 2 without a result where the cell's cards are missing, 3 where a
forbidden module (JAX, flax, the JAX package) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100.lib import env  # noqa: E402

env.set_caches(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from bench_h100.lib import runner

    try:
        runner.run(a.workload, a.seed, a.seconds, bool(a.trace), root=ROOT, t_start=T_START)
    except runner.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
