"""The port's public API against the JAX package's (CPU).

- every name of the JAX ``__all__`` of ``diffusion``, ``train``, ``models``
  and ``data`` imports from the port (``EmaState`` and ``TrainState``, flax
  pytrees, have no counterpart);
- the three beta schedules, and ``make_residual_schedule`` under each (train
  and test, DDIM-converted), in JAX's argument order, against JAX at rtol
  1e-6; ``make_gaussian_schedule`` under both of its schedules; the
  positional call ``make_beta_schedule(T, "linear")``; the errors of an
  unknown name;
- ``Trainer.train(profile_dir=..., profile_steps=(1, 2))`` on a micro trainer
  (3 steps) writes a Chrome trace with the ``train.step`` ranges; without
  ``profile_dir`` no profiler is made.
"""

import dataclasses
import glob
import importlib
import json

import numpy as np
import pytest
import torch

import founddiff_tpu.data as jdata
import founddiff_tpu.diffusion as jdiff
import founddiff_tpu.models as jmodels
import founddiff_tpu.train as jtrain
from founddiff_tpu.diffusion import schedules as jsched
from founddiff_tpu_torch.diffusion import schedules as tsched
from torch_parity import MICRO_CLIP

NOT_PORTED = {"EmaState", "TrainState"}
SCHEDULES = ("linear", "scaled_linear", "squaredcos_cap_v2")


@pytest.mark.parametrize("jmod", [jdiff, jtrain, jmodels, jdata], ids=lambda m: m.__name__)
def test_exported_names(jmod):
    port = importlib.import_module(jmod.__name__.replace("founddiff_tpu", "founddiff_tpu_torch"))
    want = set(jmod.__all__) - NOT_PORTED
    assert want <= set(port.__all__)
    for name in want:
        assert getattr(port, name) is not None, name


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", SCHEDULES)
def test_beta_schedules(name):
    for T in (10, 1000):
        got = tsched.make_beta_schedule(T, name)
        assert got.dtype == np.float32
        _close(got, jsched.make_beta_schedule(T, name))
    _close(tsched.make_beta_schedule(50, name, 0.0005, 0.03),
           jsched.make_beta_schedule(50, name, 0.0005, 0.03))
    _close(tsched.betas_for_alpha_bar(100, 0.5), jsched.betas_for_alpha_bar(100, 0.5))


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("test", [False, True])
def test_residual_schedule_under_each(name, test):
    kw = dict(test=test, beta_schedule=name, beta_start=0.0002, beta_end=0.03)
    got = tsched.make_residual_schedule(200, **kw)
    want = jsched.make_residual_schedule(200, **kw)
    for f in dataclasses.fields(want):
        if f.name == "num_timesteps":
            assert got.num_timesteps == want.num_timesteps == 200
        else:
            _close(getattr(got, f.name).numpy(), getattr(want, f.name))


@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_gaussian_schedule_under_each(name):
    got = tsched.make_gaussian_schedule(300, beta_schedule=name, p2_loss_weight_gamma=0.5)
    want = jsched.make_gaussian_schedule(300, beta_schedule=name, p2_loss_weight_gamma=0.5)
    for f in dataclasses.fields(want):
        if f.name != "num_timesteps":
            _close(getattr(got, f.name).numpy(), getattr(want, f.name))


def test_positional_call_and_unknown_names():
    got = tsched.make_beta_schedule(100, "linear")
    _close(got, np.linspace(0.0001, 0.02, 100, dtype=np.float32))
    _close(got, jsched.make_beta_schedule(100, "linear"))
    for mod in (tsched, jsched):
        with pytest.raises(NotImplementedError, match="unknown beta schedule 'cosine'"):
            mod.make_beta_schedule(10, "cosine")
        with pytest.raises(NotImplementedError):
            mod.make_residual_schedule(10, beta_schedule="quadratic")
        with pytest.raises(ValueError, match="unknown beta schedule"):
            mod.make_gaussian_schedule(10, beta_schedule="scaled_linear")


def _micro_trainer(tmp_path, steps):
    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.train import Trainer

    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    cfg.diffusion.image_size = 16
    cfg.train = dataclasses.replace(cfg.train, train_num_steps=steps,
                                    checkpoint_folder=str(tmp_path / "ckpt"))
    diffusion, model = build(cfg, device="cpu", seed=0, clip_overrides=MICRO_CLIP, train=True)
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.rand(4, 16, 16, 1, generator=gen),) * 2 for _ in range(steps)]
    return Trainer(diffusion, model, cfg), batches


def test_trace_hook(tmp_path, monkeypatch):
    from founddiff_tpu_torch.train import trainer as trainer_mod

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        made = []
        start = trainer_mod._start_trace
        monkeypatch.setattr(trainer_mod, "_start_trace",
                            lambda: made.append(start()) or made[-1])
        trainer, batches = _micro_trainer(tmp_path, 2)
        trainer.train(batches, log_every=1)
        assert trainer.step == 2 and made == []
        trainer, batches = _micro_trainer(tmp_path, 3)
        trainer.train(batches, log_every=1, profile_dir=str(tmp_path / "prof"),
                      profile_steps=(1, 2))
    finally:
        torch.set_num_threads(before)
    assert trainer.step == 3 and len(made) == 1
    (path,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    events = json.load(open(path))["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and any(e.get("args", {}).get("Input Dims") for e in ops)  # shapes recorded
    assert any(e.get("name") == "train.step" for e in events)  # the program's spans recorded
