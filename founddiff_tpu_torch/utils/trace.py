"""Spans and counters of the program, on the clock of ``torch.profiler``'s events.

A span marks one phase of the program: a request, the tower, a DDIM step, a
train step and its parts, a kernel wrapper.  Spans record only inside
:func:`recording`; outside it ``span`` tests one flag and returns a shared
context that does nothing.  A recorded span holds its name, its parent, the
id of the outermost span open around it (its root: a request or a step),
its host start and end in ns on ``time.time_ns()``'s clock (the clock of
the profiler's events, host and device alike, so spans can be laid over a
profiler window that records the device alone), with ``device=True`` its
time on the device from a CUDA event pair, and its attributes.  Spans whose
name does not start with ``kernel.`` also open a
``torch.profiler.record_function`` range, so a profiler that records the
host shows the program's phases.  Spans live in memory.

Counters are always on: :func:`count` adds to one registry of integers and
:func:`counters` reads it.  Each launch of a port kernel is counted there
once, under its C entry's name, where every ctypes call is checked
(:func:`founddiff_tpu_torch.ops._build.check`).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import torch

_on = False
_cuda = False  # device spans take CUDA events (else their host time stands in)
_stack: List["Span"] = []  # the open spans, innermost last
_spans: List["Span"] = []  # the closed spans of the current recording
_last_id = 0
_pool: list = []  # CUDA event pairs, reused across recordings
_counts: Dict[str, int] = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span; ``host_ms`` and ``ms`` (the device time where the
    span took CUDA events, else the host time) once closed."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns", "device_ms",
                 "_events", "_range")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.attrs, self.device_ms = name, attrs, None
        self._events = (_pool.pop() if _pool else (torch.cuda.Event(enable_timing=True),
                                                   torch.cuda.Event(enable_timing=True))
                        ) if device and _cuda else None
        self._range = None if name.startswith("kernel.") else \
            torch.profiler.record_function(name)

    def __enter__(self):
        global _last_id
        _last_id += 1
        parent = _stack[-1] if _stack else None
        self.id, self.parent = _last_id, parent.id if parent else None
        self.root = parent.root if parent else self.id
        _stack.append(self)
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack.remove(self)
        _spans.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def ms(self) -> float:
        return self.host_ms if self.device_ms is None else self.device_ms


def span(name: str, device: bool = False, **attrs):
    """``with span(name, device=..., **attrs):`` a phase of the program."""
    if not _on:
        return _OFF
    return Span(name, device, attrs)


def traced(name: str, device: bool = False):
    """Decorates a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with Span(name, device, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters(since: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The registry; with ``since`` (an earlier reading) the counts added
    after it, nonzero ones only."""
    if since is None:
        return dict(_counts)
    return {k: v - since.get(k, 0) for k, v in _counts.items() if v != since.get(k, 0)}


class Record:
    """What :func:`recording` saw: ``spans`` in the order they closed, and
    ``counters``, the counts added inside it."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` turns spans on; on leaving, the device
    times are read (one synchronisation) and ``rec`` is filled."""
    global _on, _cuda, _spans
    if _on:
        raise RuntimeError("spans are already recording")
    rec, before = Record(), counters()
    _cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    _spans, _on = rec.spans, True
    try:
        yield rec
    finally:
        _on, _spans = False, []
        rec.counters = counters(before)
        timed = [s for s in rec.spans if s._events is not None]
        if timed:
            torch.cuda.synchronize()
        for s in timed:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            _pool.append(s._events)
            s._events = None
