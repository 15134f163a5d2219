"""The numbers that decide ``correct``: what the timed path produced against
what the reference computes from the same weights and inputs.

Serving: per compared request, the RMS and the largest absolute difference
of the denoised slices (in the [0, 1] image units), and the largest
absolute difference of the tower's dose and content embeddings over the
reference's largest magnitude.

Training: the first step's loss, and by parameter leaf the gap between the
program's and the reference's norms of a leaf (of the first gradient, of
the change after the compared steps, of the EMA's change), over the larger
of the reference's norm of that leaf and the median leaf's (some gradients
are all but zero), taken at the worst leaf and at the median leaf.  Leaves
whose reference gradient is under a thousandth of the median leaf's move
under Adam by round-off alone (a convolution's bias in front of a
GroupNorm); they are left out of every leaf number.
"""

from __future__ import annotations

import statistics

NEGLIGIBLE = 1e-3  # of the median leaf's gradient norm


def serve_numbers(program_out, reference_out, program_emb, reference_emb) -> dict:
    diff = program_out.float().cpu() - reference_out.float().cpu()
    embed = max(float((p.float() - r.float()).abs().max() / r.float().abs().max())
                for p, r in zip(program_emb, reference_emb))
    return dict(out_rmse=float(diff.square().mean().sqrt()), out_max_abs=float(diff.abs().max()),
                embed_gap=embed)


def worst(numbers: list) -> dict:
    """The largest reading of each number over several compared units."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def train_numbers(prog: dict, ref: dict, start: dict):
    """``prog`` / ``ref``: ``losses`` (per step), ``grad1`` (the clipped
    first gradient by leaf), ``params`` (after the last compared step) and
    ``ema`` (the EMA after it) by leaf name; ``start``: the parameters
    before the first step.  Returns the numbers, each worst leaf's name and
    the leaves left out."""
    g_ref = _norms(ref["grad1"])
    med = statistics.median(g_ref.values())
    leaves = [n for n, g in g_ref.items() if g >= NEGLIGIBLE * med]
    delta = lambda p: _norms({n: p[n].float() - start[n].float() for n in leaves})
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    by_leaf = dict(grad=_leaf_gaps(_norms({n: prog["grad1"][n] for n in leaves}), g_ref, leaves),
                   step=_leaf_gaps(delta(prog["params"]), delta(ref["params"]), leaves),
                   ema=_leaf_gaps(delta(prog["ema"]), delta(ref["ema"]), leaves))
    numbers = dict(loss_gap_first=gaps[0], loss_gap=max(gaps))
    worst = {}
    for k, g in by_leaf.items():
        worst[k] = max(g, key=g.get)
        numbers[f"{k}_gap"] = g[worst[k]]
        numbers[f"{k}_gap_median"] = statistics.median(g.values())
    return numbers, dict(worst=worst, loss_gaps=gaps,
                         left_out=sorted(set(g_ref) - set(leaves)))


def judge(numbers: dict, limits: dict) -> list:
    """``[(name, value, limit, ok)]`` for every number that has a limit."""
    rows = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and value == value and value <= limit
        rows.append((name, value, limit, ok))
    return rows
