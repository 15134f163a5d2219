"""The program's own spans and launch counters, read in a traced window.

The port records spans (a request, the tower, each DDIM step, the train
step's phases, each kernel wrapper) and counts each launch of its own
kernels (``founddiff_tpu_torch.utils.trace``).  :func:`window` runs a cell's
units of work twice in profiler windows that record the device alone:
first with the spans off, then inside ``recording()``.  The unit time of the
second over the first's is what recording costs.  From the second come the
spans, the counter deltas, and each idle stretch of the device put down to
the innermost program span open on the host at its middle (the rule the
host window's idle gaps follow), ``outside the program`` where none was
open.  On a host without a card no profiler runs, device spans take their
host time, and no idle is put down.  A program without the trace module
gives None.

:func:`metrics` reduces the window to per-layer numbers.
"""

from __future__ import annotations

import contextlib
import time

from bench_h100.lib import trace

OUTSIDE = "outside the program"


def _run(cell, first: int, n: int, cuda: bool, recording=None):
    """Units ``first .. first + n - 1``; returns (seconds, device intervals
    in ns, the window's ends in ns, the record or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA]) if cuda else contextlib.nullcontext()
    with prof:
        if cuda:
            torch.cuda.synchronize()
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        with recording() if recording else contextlib.nullcontext() as rec:
            for i in range(n):
                cell.run_once(first + i)
        if cuda:
            torch.cuda.synchronize()
        seconds, t1_ns = time.perf_counter() - t0, time.time_ns()
    device = []
    if cuda:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                start = trace._ns(e, "start")
                device.append((start, start + trace._ns(e, "duration"), e.name()))
    return seconds, device, (t0_ns, t1_ns), rec


def idle_by_span(device, spans, ends) -> dict:
    """Seconds of idle device per innermost open span: every stretch of the
    window ``ends`` that no device operation covers (before the first,
    between two, after the last), named at its middle."""
    t0, t1 = ends
    busy = [(max(s, t0), min(e, t1)) for s, e in trace._merge((s, e) for s, e, _ in device)
            if e > t0 and s < t1]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = sorted((s["start_ns"], s["end_ns"], s["name"]) for s in spans)
    out = {}
    for (a, b), name in zip(gaps, trace._innermost(host, [(a + b) // 2 for a, b in gaps])):
        name = OUTSIDE if name == "host (no operator)" else name
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def window(cell, first: int, n: int, cuda: bool):
    """The two windows over ``n`` units from unit ``first`` (2 n units in
    all): a dict with ``spans``, ``counters``, ``units``, ``unit_s`` (off
    and on), ``window_s``, ``busy_s``, ``kernels`` and, on a card,
    ``idle_by_span``; None where the program records no spans."""
    try:
        from founddiff_tpu_torch.utils.trace import recording
    except ImportError:
        return None
    off_s, off_device, _, _ = _run(cell, first, n, cuda)
    on_s, device, ends, rec = _run(cell, first + n, n, cuda, recording)
    spans = [dict(name=s.name, id=s.id, parent=s.parent, root=s.root, start_ns=s.start_ns,
                  end_ns=s.end_ns, ms=s.ms, host_ms=s.host_ms, attrs=s.attrs)
             for s in rec.spans]
    out = dict(spans=spans, counters=rec.counters, units=n,
               unit_s=dict(off=off_s / n, on=on_s / n), window_s=(ends[1] - ends[0]) / 1e9)
    if cuda:
        busy = trace._merge((s, e) for s, e, _ in device)
        out.update(busy_s=sum(e - s for s, e in busy) / 1e9,
                   kernels=sum(1 for *_, k in off_device if not k.startswith(("Memcpy", "Memset")))
                   / n, idle_by_span=idle_by_span(device, spans, ends))
    return out


def _sum(program, name, clock="ms"):
    found = [s[clock] for s in program["spans"] if s["name"] == name]
    return (sum(found), len(found)) if found else (None, 0)


def metrics(program, trains: bool) -> dict:
    """The per-layer numbers of a window; a number with nothing to read is
    left out."""
    units, out = program["units"], {}
    if trains:
        update, _ = _sum(program, "train.update")
        draws, _ = _sum(program, "train.draws", "host_ms")
        out["update_ms_per_step.train"] = None if update is None else update / units
        out["draw_host_ms_per_step.train"] = None if draws is None else draws / units
    else:
        tower, _ = _sum(program, "tower")
        steps, n_steps = _sum(program, "ddim.step")
        launches = sum(program["counters"].values())
        out["tower_ms.serve"] = None if tower is None else tower / units
        out["ddim_step_ms.serve"] = None if steps is None else steps / n_steps
        out["port_launches_per_request.serve"] = launches / units if launches else None
    idle = program.get("idle_by_span")
    if idle is not None:
        wrapper = sum(s for name, s in idle.items() if name.startswith("kernel."))
        out["wrapper_idle_pct." + ("train" if trains else "serve")] = \
            100.0 * wrapper / program["window_s"]
    return {k: v for k, v in out.items() if v is not None}
