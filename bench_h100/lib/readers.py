"""What the per-layer metrics' readers share.  Each reader returns None when
the run has nothing to read (no device time traced, no span recorded), and
the harness then leaves the metric out."""

from __future__ import annotations

from bench_h100.lib import peaks


def idle_pct(ctx):
    t = getattr(ctx, "trace", None)
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx, unit: str):
    """Σ operations / their unit's peak of the window's units of work, over
    the window's time, in %."""
    if not ctx.cuda:
        return None
    per_unit = peaks.peak_seconds(ctx.work(unit).work(ctx.config, ctx.traffic))
    return 100.0 * per_unit * ctx.window["units"] / ctx.window["seconds"]


def ss2d_roofline(ctx, phases):
    """Σ least time / Σ CUDA-event time over every SS2D call of the span
    window, in %."""
    calls = [r for r in ctx.spans.get("SS2D", []) if r[0] in phases]
    if not ctx.cuda or not calls:
        return None
    least = ctx.work("ss2d").least_seconds
    return 100.0 * sum(least(meta, phase) for phase, _, meta in calls) \
        / sum(s for _, s, _ in calls)


def span_ms_per_forward(ctx, cls: str):
    """ms of every ``cls`` forward call per UNet forward of the span window."""
    calls = [s for phase, s, _ in ctx.spans.get(cls, []) if phase == "forward"]
    if not ctx.cuda or not calls:
        return None
    forwards = ctx.span_units * ctx.config["program"]["diffusion"]["sampling_timesteps"]
    return 1e3 * sum(calls) / forwards


def op_ms_per_unit(ctx, ops):
    t = getattr(ctx, "trace", None)
    if not t or t["busy_s"] <= 0:
        return None
    total = sum(t["op_device_s"].get(op, 0.0) for op in ops)
    return 1e3 * total / ctx.trace_units if total > 0 else None


def kernels_per_unit(ctx):
    t = getattr(ctx, "trace", None)
    if not t or t["kernels"] <= 0:
        return None
    return t["kernels"] / ctx.trace_units
