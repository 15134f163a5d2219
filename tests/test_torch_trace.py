"""The port's spans and launch counters (``founddiff_tpu_torch/utils/trace.py``), on the CPU.

- off, ``span`` hands back one shared context and records nothing;
- on, spans nest: parents, the root's id on every span of a request or a
  step, attributes, host times inside their parent's; ``traced`` as
  ``span``; a second ``recording`` inside one refuses;
- the counters: deltas over a ``recording`` and against an earlier reading;
  ``_build.check`` counts a checked call under its entry, a fused entry's
  launches under the entries they stand for, and nothing for a failed call;
- a span's host start lies within 2 ms of the ``record_function`` event of
  the same name in a CPU profiler window (one clock);
- a micro hoisted-sampler request: one ``serve.request``, one ``tower`` and
  ``sampling_timesteps`` ``ddim.step`` spans carrying the request's id, the
  model's ``mamba_block`` and ``ss2d`` spans under the steps; a micro train
  step: ``train.step`` with ``train.draws``, ``train.forward_loss``,
  ``train.backward`` and ``train.update`` (``train.clip``,
  ``train.optimizer``), ``train.ema`` on blend steps only.
"""

import dataclasses
import time

import pytest
import torch

from founddiff_tpu_torch.ops import _build
from founddiff_tpu_torch.utils import trace
from torch_parity import MICRO_CLIP
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def test_off_records_nothing():
    assert trace.span("a") is trace.span("b", device=True, t=1) is trace._OFF
    with trace.span("a") as s:
        assert s is None
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_nesting_parents_and_roots():
    @trace.traced("leaf")
    def leaf(x):
        return x + 1

    with trace.recording() as rec:
        for i in range(2):
            with trace.span("root", step=i):
                with trace.span("mid", device=True):
                    assert leaf(i) == i + 1
                leaf(i)
        leaf(0)
    by_id = {s.id: s for s in rec.spans}
    named = [(s.name, by_id[s.parent].name if s.parent else None) for s in rec.spans]
    assert named == [("leaf", "mid"), ("mid", "root"), ("leaf", "root"),
                     ("root", None)] * 2 + [("leaf", None)]
    roots = [s for s in rec.spans if s.name == "root"]
    assert [r.attrs for r in roots] == [{"step": 0}, {"step": 1}]
    for s in rec.spans:
        if s.parent is None:
            assert s.root == s.id
            continue
        parent = by_id[s.parent]
        assert s.root == parent.root and by_id[s.root].name == "root"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert roots[0].root != roots[1].root
    assert all(s.device_ms is None and s.ms == s.host_ms >= 0 for s in rec.spans)  # no card
    with trace.recording():
        with pytest.raises(RuntimeError, match="already recording"):
            with trace.recording():
                pass


def test_counters_give_deltas():
    trace.count("test.a", 3)
    before = trace.counters()
    with trace.recording() as rec:
        trace.count("test.a")
        trace.count("test.b", 2)
    trace.count("test.b")
    assert rec.counters == {"test.a": 1, "test.b": 2}
    assert trace.counters(before) == {"test.a": 1, "test.b": 3}
    assert trace.counters()["test.a"] == before["test.a"] + 1


def test_check_counts_each_launch_once():
    before = trace.counters()
    _build.check(0, "ln_forward")
    _build.check(0, "gn_silu_forward", ("gn_stats_forward", "gn_apply_forward"))
    with pytest.raises(RuntimeError, match="ln_mod_forward: CUDA error 700"):
        _build.check(700, "ln_mod_forward")
    assert trace.counters(before) == {"ln_forward": 1, "gn_stats_forward": 1,
                                      "gn_apply_forward": 1}


def test_spans_on_the_profilers_clock():
    """Spans are stamped on ``time.time_ns()``'s clock, the clock of the
    profiler's events: each coarse span's host start lies within 2 ms of
    its ``record_function`` event's; ``kernel.*`` spans open none."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            for i in range(3):
                with trace.span("clock.phase", i=i):
                    with trace.span("kernel.clock"):
                        x = x @ x / 256
                    time.sleep(0.002)
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "clock.phase")
    starts = [s.start_ns for s in rec.spans if s.name == "clock.phase"]
    assert len(events) == len(starts) == 3
    assert max(abs(a - b) for a, b in zip(events, starts)) < 2e6
    assert not any(e.name() == "kernel.clock" for e in prof.profiler.kineto_results.events())


def _micro(train=False, steps=2):
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build

    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    cfg.diffusion.image_size = 16
    cfg.train = dataclasses.replace(cfg.train, train_num_steps=steps)
    diffusion, model = build(cfg, device="cpu", seed=0, clip_overrides=MICRO_CLIP, train=train)
    return cfg, diffusion, model


def test_request_spans():
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    cfg, diffusion, model = _micro()
    sample = make_hoisted_sampler(model, diffusion)
    x = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    with trace.recording() as rec:
        out = sample(x)
    assert out.shape == x.shape
    names = [s.name for s in rec.spans]
    (req,) = [s for s in rec.spans if s.name == "serve.request"]
    (tower,) = [s for s in rec.spans if s.name == "tower"]
    steps = [s for s in rec.spans if s.name == "ddim.step"]
    assert len(steps) == cfg.diffusion.sampling_timesteps == 2
    assert [(s.attrs["t"], s.attrs["t_next"]) for s in steps] == [(999, 499), (499, -1)]
    assert all(s.root == req.id for s in rec.spans) and req.parent is None
    assert tower.parent == req.id and all(s.parent == req.id for s in steps)
    assert tower.end_ns <= steps[0].start_ns
    step_ids = {s.id for s in steps}
    blocks = [s for s in rec.spans if s.name == "mamba_block"]
    assert blocks and all(s.parent in step_ids for s in blocks)
    assert names.count("ss2d") == len(blocks)
    assert sum(s.ms for s in steps) + tower.ms <= req.ms
    assert rec.counters == {}  # the CPU takes the plain versions


def test_train_step_spans():
    from founddiff_tpu_torch.train import Trainer

    cfg, diffusion, model = _micro(train=True)
    trainer = Trainer(diffusion, model, cfg)
    batch = (torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(1)),) * 2
    with trace.recording() as rec:
        for _ in range(2):  # the EMA blends at its counter 0, not at 1
            trainer.train_step(batch)
    steps = [s for s in rec.spans if s.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    by_id = {s.id: s for s in rec.spans}
    for i, step in enumerate(steps):
        mine = [s for s in rec.spans if s.root == step.id]
        child = lambda name: [s for s in mine if s.name == name]
        parent_name = lambda s: by_id[s.parent].name
        accum = cfg.train.gradient_accumulate_every
        assert len(child("train.forward_loss")) == len(child("train.backward")) == accum
        assert len(child("train.update")) == 1
        assert {parent_name(s) for s in child("train.forward_loss")} == {"train.step"}
        assert {parent_name(s) for s in child("train.draws")} == {"train.forward_loss"}
        assert len(child("train.draws")) == 2 * accum  # t in ``loss``, noise in ``p_losses``
        for name in ("train.clip", "train.optimizer"):
            assert [parent_name(s) for s in child(name)] == ["train.update"]
        assert [parent_name(s) for s in child("train.ema")] == (["train.update"] if i == 0
                                                                else [])
        assert not child("train.all_reduce")
        assert len(child("tower")) == accum  # the frozen tower in each forward
