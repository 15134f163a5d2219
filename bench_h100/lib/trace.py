"""The profiler's windows, reduced in memory.

``torch.profiler`` traces a few units of work; the trace is never written
out.  A device window records the card's activity alone (CUPTI), which
adds little to the host's time: from it come the device's busy time (the
union of every operation on the device) over the window's length, the
device operations that took most time and the number of kernels run.  A
host window records the host's operators too, which costs host time on
every launch: from it come the longest idle gaps named by what the host
was doing in them (the innermost host operation open at the gap's middle)
and the device time under chosen host operators.  On a host without a card
only a host window is taken.
"""

from __future__ import annotations

import time

import torch

TOP = 10


def _ns(e, what: str) -> int:
    fn = getattr(e, what + "_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, what + "_us")() * 1000)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point (sorted), the name of the innermost host event open at
    it (the one that started last), or ``"host (no operator)"``."""
    out, active, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= p]
        out.append(max(active)[2] if active else "host (no operator)")
    return out


class Profile:
    """``with Profile(cuda, host) as prof: <units of work>``; then
    ``prof.summary(ops)``.  ``host``: record the host's operators too."""

    def __init__(self, cuda: bool, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU] if host or not cuda else []) \
            + ([ProfilerActivity.CUDA] if cuda else [])
        self.cuda = cuda
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        return False

    def summary(self, ops=()) -> dict:
        """busy_s, window_s, kernels, the top device operations, the top idle
        gaps by host activity, and ``op_device_s``: the device time under each
        host operator named in ``ops`` (children included)."""
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            item = (start, start + _ns(e, "duration"), e.name())
            (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
        host.sort()
        busy = _merge((s, e) for s, e, _ in device)
        by_op = {}
        for s, e, name in device:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        by_host = {}
        for (s, e), name in zip(gaps, _innermost(host, [(s + e) // 2 for s, e in gaps])):
            by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        op_device_s = {}
        if ops:
            for avg in self._prof.key_averages():
                if avg.key in ops:
                    total = getattr(avg, "device_time_total", None)
                    if total is None:
                        total = avg.cuda_time_total
                    op_device_s[avg.key] = op_device_s.get(avg.key, 0.0) + total / 1e6
        kernels = sum(1 for _, _, n in device if not n.startswith(("Memcpy", "Memset")))
        return dict(busy_s=sum(e - s for s, e in busy) / 1e9, window_s=self.window_s,
                    kernels=kernels, device_ops=top(by_op), idle_gaps=top(by_host),
                    op_device_s=op_device_s)
