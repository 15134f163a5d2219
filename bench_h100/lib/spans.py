"""Spans around the program's module calls, from the benchmark's side.

Forward hooks (and, for training, full backward hooks) on the modules of
the system under test whose class has one of the given names record a
CUDA event pair around each call; on a host without a card the host clock
stands in (the CPU tests only).  The hooks are removed when the window
closes, so no timed run carries them.
"""

from __future__ import annotations

import time

import torch


class _Mark:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        if cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.t = time.perf_counter()

    def seconds_to(self, end: "_Mark") -> float:
        if self.cuda:
            return self.event.elapsed_time(end.event) / 1e3
        return end.t - self.t


def _meta(module, args) -> dict:
    x = args[0] if args and torch.is_tensor(args[0]) else None
    attrs = {k: getattr(module, k) for k in ("d_inner", "d_state", "dt_rank")
             if hasattr(module, k)}
    if x is not None:
        attrs.update(shape=tuple(x.shape), dtype=str(x.dtype).replace("torch.", ""))
    return attrs


class Spans:
    """``with Spans(model, ("SS2D", "MambaBlock"), backward=...) as s:``;
    afterwards ``s.records[class] = [(phase, seconds, meta), ...]``."""

    def __init__(self, model: torch.nn.Module, classes, backward: bool = False):
        self.model, self.classes, self.backward = model, tuple(classes), backward
        self.cuda = next(model.parameters()).is_cuda
        self.records = {c: [] for c in self.classes}
        self._open, self._pairs, self._hooks = {}, [], []

    def _start(self, phase, module, args):
        self._open.setdefault((phase, id(module)), []).append(
            (_Mark(self.cuda), _meta(module, args) if phase == "forward" else None))

    def _end(self, phase, module):
        start, meta = self._open[(phase, id(module))].pop()
        if meta is None:  # a backward call carries its forward's shapes
            meta = self._shapes.get(id(module), {})
        else:
            self._shapes[id(module)] = meta
        self._pairs.append((type(module).__name__, phase, start, _Mark(self.cuda), meta))

    def __enter__(self):
        self._shapes = {}
        for m in self.model.modules():
            if type(m).__name__ not in self.classes:
                continue
            self._hooks += [
                m.register_forward_pre_hook(lambda mod, a: self._start("forward", mod, a)),
                m.register_forward_hook(lambda mod, a, out: self._end("forward", mod))]
            if self.backward:
                self._hooks += [
                    m.register_full_backward_pre_hook(
                        lambda mod, g: self._start("backward", mod, ())),
                    m.register_full_backward_hook(
                        lambda mod, gi, go: self._end("backward", mod))]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        if self.cuda:
            torch.cuda.synchronize()
        for cls, phase, start, end, meta in self._pairs:
            self.records[cls].append((phase, start.seconds_to(end), meta))
        return False
