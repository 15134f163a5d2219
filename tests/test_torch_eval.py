"""The port's evaluation path against the JAX package's at shared weights,
dim 8 x (1, 2) on 16^2 slices, fp32, with the JAX draws handed in:

- ``Trainer.test`` on a synthetic Mayo-2020 ``test`` tree of 32 slices, with
  the micro Dose-CLIP tower (the hoisted sampler) and without a tower
  (``ResidualDiffusion.sample``): every saved ``.npy`` prediction within
  rtol 1e-3 / atol 2e-3 (the DDIM image, as since the first slice), the
  summary and every per-anatomy / per-dose log line's numbers within rtol
  1e-3, the same names; the Dose-CLIP FID within rtol 1e-2;
- the no-tower ``UnetRes`` build and forward (rtol 1e-3 / atol 1e-4);
- ``Trainer.load_torch`` of a ``model-<n>.pt`` written by the port's
  ``save``, read by the port and by the JAX ``load_reference_checkpoint``;
  the reference layout read with ``weights_only=True``, a crafted file
  refused;
- the ``Config`` JSON across the two packages.

Full-T sampling is held in ``test_torch_fullt.py``.
"""

import dataclasses
import functools
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.config import Config as JConfig
from founddiff_tpu.data import PDFDataset as JPDF
from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.models import UnetRes as JUnetRes
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.train import Trainer as JTrainer
from founddiff_tpu.utils.torch_convert import convert_denoiser_params
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.data import PDFDataset as TPDF
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.models.unet import UnetRes
from founddiff_tpu_torch.train.trainer import Trainer
from founddiff_tpu_torch.utils.convert import from_jax_params
from test_data import _write_tree
from torch_parity import _QUICK_COMPILE as QUICK_COMPILE
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import MICRO_CLIP, jit_quick, np_, perturb, t_

RTOL, ATOL, IMG_ATOL = 1e-3, 1e-4, 2e-3
DIM, MULTS, SIZE = 8, (1, 2), 16
# _write_tree(n=4): ab and lung at stride 2 take 2 slices a dose, head 4
EVAL_COUNTS = (("ab", 2), ("lung", 2), ("head", 4))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_(a), np.asarray(b, np.float32), rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _jax_model(tower: bool):
    """The micro JAX model and its params: the port's seeded init carried
    into the JAX tree by the JAX converter (the tree's shapes from
    ``eval_shape``, which compiles nothing), adaLN and prompt perturbed."""
    kw = dict(dim=DIM, dim_mults=MULTS, objective="pred_res", test_res_or_noise="res",
              scan_impl="chunked")
    if tower:
        jm = JFoundDiff(**kw, clip_overrides=MICRO_CLIP)
    else:
        jm = JUnetRes(**kw, channels=1, num_unet=1, condition=True)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(7), x0, time0)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, model = build(_port_config(tower, "unused"), device="cpu", seed=7,
                     clip_overrides=MICRO_CLIP)
    state = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    params, _, missing = convert_denoiser_params(
        state, template, num_res=len(MULTS), with_dose_encoder=tower,
        clip_vision_layers=(1, 1, 1, 1), clip_transformer_layers=2)
    assert missing == []
    return jm, perturb(params, seed=7)


def _compiled_once(jitted):
    """``jitted`` lowered and compiled at its first call with the quick CPU
    options of ``torch_parity.jit_quick``, then reused (every call of the
    JAX ``Trainer.test`` sampler has the same shapes)."""
    done = []

    def call(*args):
        if not done:
            done.append(jitted.lower(*args).compile(QUICK_COMPILE))
        return done[0](*args)

    return call


@pytest.fixture(scope="module", params=[True, False], ids=["tower", "no_tower"])
def models(request):
    return (request.param, *_jax_model(request.param))


def _port_config(tower: bool, folder: str, timesteps: int = 20, sampling: int = 2) -> Config:
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.model.use_dose_encoder = tower
    cfg.diffusion.image_size = SIZE
    cfg.diffusion.timesteps, cfg.diffusion.sampling_timesteps = timesteps, sampling
    cfg.train.checkpoint_folder = folder
    cfg.data.eval_counts, cfg.data.eval_doses = EVAL_COUNTS, 4
    return cfg


def _port(tower, params, folder, **kw):
    cfg = _port_config(tower, folder, **kw)
    diffusion, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP, train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    return cfg, diffusion, model


def _jax_diffusion(jm, timesteps=20, sampling=2):
    return JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s),
                      image_size=SIZE, timesteps=timesteps, sampling_timesteps=sampling,
                      objective="pred_res", loss_type="l2", condition=True, sum_scale=0.01,
                      test_res_or_noise="res")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mayo"))
    _write_tree(root, "test", n=4)
    return root


def _messages(path):
    """The message of each log line (after the JAX format's ``] `` prefix)."""
    return [line.split("] ", 1)[1] for line in open(path).read().splitlines()]


def _numbers(msg):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", msg)]


def test_trainer_test_against_jax(models, tree, tmp_path):
    tower, jm, params = models
    jcfg = JConfig()
    jcfg.model.dim, jcfg.model.dim_mults = DIM, MULTS
    jcfg.model.use_dose_encoder = tower
    jcfg.diffusion.image_size = SIZE
    jcfg.train.checkpoint_folder = str(tmp_path / "jax")
    jcfg.data.eval_counts, jcfg.data.eval_doses = EVAL_COUNTS, 4
    jtrainer = JTrainer(_jax_diffusion(jm), params, jcfg,
                        sample_dataset=JPDF("test", root=tree, num=100),
                        model=jm if tower else None)
    # the JAX draws: one key per slice split from the trainer's, and the
    # sampler's initial normal from the second half of that key
    n = len(jtrainer.sample_dataset)
    assert n == sum(c for _, c in EVAL_COUNTS) * 4 == 32
    _, rng = jax.random.split(jtrainer.rng)
    noises = []
    for _ in range(n):
        rng, srng = jax.random.split(rng)
        noises.append(t_(jax.random.normal(jax.random.split(srng)[1], (1, SIZE, SIZE, 1))))
    jtrainer._jit_cache["sample_True"] = _compiled_once(jtrainer._sample_fn(True))
    want = jtrainer.test(save_npy=True, fid=True)

    cfg, diffusion, model = _port(tower, params, str(tmp_path / "port"))
    trainer = Trainer(diffusion, model, cfg, sample_dataset=TPDF("test", root=tree, num=100))
    trainer._slice_noise = lambda i, shape: noises[i]
    got = trainer.test(save_npy=True, fid=True)

    assert set(got) == set(want) == {"psnr", "ssim", "rmse", "fid_doseclip"}
    for k in ("psnr", "ssim", "rmse"):
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    if tower:
        assert np.isfinite(got["fid_doseclip"])
        assert got["fid_doseclip"] == pytest.approx(want["fid_doseclip"], rel=1e-2)
    else:  # no tower to extract features with: NaN, as in JAX
        assert np.isnan(got["fid_doseclip"]) and np.isnan(want["fid_doseclip"])
    names = sorted(os.listdir(jtrainer.results_folder))
    assert sorted(f for f in os.listdir(trainer.results_folder) if f.endswith(".npy")) == \
        sorted(f for f in names if f.endswith(".npy"))
    assert len([f for f in names if f.endswith(".npy")]) == n
    for f in names:
        if f.endswith(".npy"):
            a = np.load(os.path.join(trainer.results_folder, f))
            assert a.shape == (SIZE, SIZE)
            _close(a, np.load(os.path.join(jtrainer.results_folder, f)), atol=IMG_ATOL)
    jlog = _messages(os.path.join(jtrainer.checkpoint_folder, "test.log"))
    tlog = _messages(os.path.join(trainer.checkpoint_folder, "test.log"))
    assert len(tlog) == len(jlog) == 3 * (1 + 4) + 1
    for tl, jl in zip(tlog, jlog):
        assert re.sub(r"-?\d+\.\d+", "#", tl) == re.sub(r"-?\d+\.\d+", "#", jl)
        np.testing.assert_allclose(_numbers(tl), _numbers(jl), rtol=RTOL, atol=1e-4)
    rec = [json.loads(line) for line in open(os.path.join(trainer.checkpoint_folder,
                                                          "metrics.jsonl"))]
    assert rec[-1]["test_psnr"] == pytest.approx(got["psnr"]) and rec[-1]["step"] == 0


def test_loop_cadence_previews_evaluates_and_saves(tmp_path, monkeypatch):
    """The loop over the train dataset's loader at the JAX cadence
    (trainer.py:220-281): a preview every ``save_and_sample_every`` steps,
    a save and ``test(fid=fid_eval)`` every 10 of them past 40; the
    no-tower FID is NaN with the JAX log line."""
    jm, params = _jax_model(False)
    cfg, diffusion, model = _port(False, params, str(tmp_path))
    cfg.train.save_and_sample_every, cfg.train.train_num_steps = 1, 50
    ds = [(np.zeros((SIZE, SIZE, 1), np.float32),) * 2] * 4
    trainer = Trainer(diffusion, model, cfg, train_dataset=ds, sample_dataset=ds)
    calls = []
    seen = []

    def step(batch):
        seen.append(tuple(np.shape(b) for b in batch))
        trainer.step += 1
        return [0.5]

    monkeypatch.setattr(trainer, "train_step", step)
    monkeypatch.setattr(trainer, "preview", lambda m: calls.append(("preview", m)))
    monkeypatch.setattr(trainer, "save", lambda m: calls.append(("save", m)))
    monkeypatch.setattr(trainer, "test", lambda **kw: calls.append(("test", kw)))
    trainer.train(log_every=10)
    assert seen[0] == ((4, SIZE, SIZE, 1),) * 2  # train_batch_size 2 x accumulate 2
    assert [c for c in calls if c[0] == "preview"] == [("preview", m) for m in range(1, 51)]
    assert [c for c in calls if c[0] != "preview"] == [("save", 50), ("test", {"last": True,
                                                                             "fid": True})]
    rec = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rec] == [1, 10, 20, 30, 40, 50] and rec[0]["loss_unet0"] == 0.5

    monkeypatch.undo()
    assert np.isnan(trainer._compute_fid([torch.zeros(1, SIZE, SIZE, 1)] * 2,
                                         [torch.ones(1, SIZE, SIZE, 1)] * 2))
    assert "fid skipped: no dose_encoder params" in open(tmp_path / "train.log").read()


def test_no_tower_build_and_forward():
    """``use_dose_encoder=False``: a UnetRes with no tower and zero
    embeddings, against the JAX UnetRes; its tree (no ``model/`` root, no
    ``dose_encoder``) covers the state dict."""
    jm, params = _jax_model(False)
    cfg, diffusion, model = _port(False, params, "unused")
    assert type(model) is UnetRes and not hasattr(model.unet0, "dose_encoder")
    assert not any("dose_encoder" in k for k in model.state_dict())
    assert set(from_jax_params(params)) == set(model.state_dict())
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, SIZE, SIZE, 2)).astype(np.float32)
    time = [rng.random(2).astype(np.float32) * 300, rng.random(2).astype(np.float32) * 30]
    want = jit_quick(lambda p, v, t: jm.apply({"params": p}, v, t))(
        params, jnp.asarray(x), [jnp.asarray(t) for t in time])
    with torch.no_grad():
        got = model.eval()(t_(x), [t_(t) for t in time])
    _close(got[0], want[0])


def test_load_torch_round_trip(tmp_path):
    """A ``model-<n>.pt`` from the port's ``save``: the port's ``load_torch``
    restores both halves and the step; the JAX ``load_reference_checkpoint``
    reads the same weights (``from_jax_params`` of its trees equals the
    port's state dicts).  Four levels, as the JAX converter's default."""
    from founddiff_tpu.train.state import TrainState, make_optimizer
    from founddiff_tpu.utils.torch_convert import load_reference_checkpoint

    mults = (1, 2, 2, 2)
    cfg = _port_config(False, str(tmp_path))
    cfg.model.dim_mults = mults
    diffusion, model = build(cfg, device="cpu", seed=5, train=True)
    trainer = Trainer(diffusion, model, cfg)
    with torch.no_grad():  # make the EMA differ from the online weights
        for p in trainer.ema.parameters():
            p.add_(0.01)
    trainer.step = trainer.ema_step = 7
    path = trainer.save(3)

    cfg2 = _port_config(False, str(tmp_path / "b"))
    cfg2.model.dim_mults = mults
    restored = Trainer(*build(cfg2, device="cpu", seed=6, train=True), cfg2)
    restored.load_torch(path)
    assert restored.step == restored.ema_step == 7
    for a, b in ((trainer.model, restored.model), (trainer.ema, restored.ema)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k

    jm = JUnetRes(dim=DIM, dim_mults=mults, objective="pred_res", test_res_or_noise="res",
                  condition=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 2)),
                            [jnp.zeros((1,)), jnp.zeros((1,))])["params"]
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    jcfg = JConfig()
    jcfg.model.use_dose_encoder = False
    state = load_reference_checkpoint(path, TrainState.create(template, make_optimizer()), jcfg)
    assert int(state.step) == 7
    for tree_, module in ((state.params, trainer.model), (state.ema.params, trainer.ema)):
        sd = from_jax_params(jax.device_get(tree_))
        own = module.state_dict()
        assert set(sd) == set(own)
        for k, v in own.items():
            torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)


def _touch(path):
    open(path, "w").close()


class _RunsCode:
    """Unpickling this calls ``_touch``: what a crafted checkpoint could do."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return _touch, (self.path,)


def test_load_torch_reads_weights_only(tmp_path):
    """The reference layout (the port's ``save`` plus the reference
    trainer's ``scaler`` and ``version`` entries) loads under
    ``weights_only=True``; a file that pickles a callable is refused before
    the callable runs."""
    cfg = _port_config(False, str(tmp_path))
    trainer = Trainer(*build(cfg, device="cpu", seed=5, train=True), cfg)
    trainer.step = trainer.ema_step = 4
    data = torch.load(trainer.save(1), weights_only=True)
    data.update(scaler=None, version="1.0")
    torch.save(data, str(tmp_path / "reference.pt"))
    cfg2 = _port_config(False, str(tmp_path / "b"))
    restored = Trainer(*build(cfg2, device="cpu", seed=6, train=True), cfg2)
    assert restored.load_torch(str(tmp_path / "reference.pt"))["version"] == "1.0"
    assert restored.step == 4
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k

    marker = tmp_path / "ran"
    data["extra"] = _RunsCode(str(marker))
    torch.save(data, str(tmp_path / "crafted.pt"))
    with pytest.raises(pickle.UnpicklingError):
        restored.load_torch(str(tmp_path / "crafted.pt"))
    assert not marker.exists()


def test_load_torch_refuses_a_file_without_the_tower(tmp_path):
    """A no-tower checkpoint cannot fill a model with the tower: the missing
    keys are named, nothing is half loaded silently."""
    jm, params = _jax_model(False)
    cfg, diffusion, model = _port(False, params, str(tmp_path))
    path = Trainer(diffusion, model, cfg).save(1)
    jm, params = _jax_model(True)
    cfg, diffusion, model = _port(True, params, str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="lacks"):
        Trainer(diffusion, model, cfg).load_torch(path)


def test_config_json_across_packages():
    """A JSON from either package loads in the other; the fields both have
    come back equal, tuples as tuples."""
    t = Config()
    t.name = "x"
    t.model.dim, t.model.dim_mults, t.model.use_dose_encoder = 16, (1, 2, 4), False
    t.train.fid_eval, t.train.use_wandb = False, True
    t.data.eval_counts, t.data.eval_doses = (("ab", 3), ("head", 1)), 2
    t.data.doses = (3, 5)
    t.mesh.data_axis, t.mesh.seq_axis = 2, 4
    j = JConfig.from_json(t.to_json())
    back = Config.from_json(j.to_json())
    assert back == t
    assert (j.mesh.data_axis, j.mesh.seq_axis) == (2, 4)
    for part in ("model", "diffusion", "train", "data", "mesh"):
        jd, td = dataclasses.asdict(getattr(j, part)), dataclasses.asdict(getattr(t, part))
        shared = set(jd) & set(td)
        assert {k: jd[k] for k in shared} == {k: td[k] for k in shared}, part
    assert j.data.eval_counts == (("ab", 3), ("head", 1)) and j.name == "x"
    assert Config.from_json(JConfig().to_json()) == Config()
