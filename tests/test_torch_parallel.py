"""The port's distribution layer against the JAX package's, on the CPU:

- row 4's last state, ``h_last``, of the plain ``scan_forward`` and of the
  dispatching ``selective_scan`` against the JAX chunked scan's
  (rtol 1e-4 / atol 1e-5);
- ``local_summary`` + ``apply_prefix`` over 2, 4 and 8 shards composed in
  one process against the JAX ``seq_sharded_selective_scan`` on the
  8-device CPU mesh (rtol 2e-4 / atol 2e-5), and an L that does not split;
- ``make_volume_denoiser`` at mesh (1, 1): the constant-residual stub of
  ``tests/test_volume.py``, and the micro FoundDiff (dim 8 x (1, 2), the
  micro Dose-CLIP tower, 16^2) fed the JAX keys' normals against the JAX
  ``make_volume_denoiser`` (rtol 1e-3, atol 2e-3 on the image);
- one spawned 2-rank gloo job (a ``FileStore`` rendezvous in a temporary
  directory) whose results the tests below read: the UNet forward with
  every SS2D over a seq group of 2 against the JAX unsharded forward
  (rtol 2e-4 / atol 2e-5), one data-parallel ``Trainer.train_step`` at mesh
  (2, 1) against the same step in one process on the global batch, fp32
  and through the bf16 ``_model_fn`` (loss within 1e-5, parameters rtol
  5e-4 / atol 1e-5), and the volume denoiser at meshes (2, 1) and (1, 2)
  against (1, 1) (rtol 2e-4);
- the command line's ``--mesh_data 1``, the two tools' ``--help`` and one
  ``denoise_volume`` run at 16^2 on the CPU.

The ranks import no JAX: the JAX package is imported inside the parent's
functions only, and its expectations and weights reach the ranks as files
(``torch.save``) in the job's directory.
"""

import functools
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.models.blocks import Block
from founddiff_tpu_torch.models.unet import UnetRes
from founddiff_tpu_torch.ops.scan import scan_chunk, scan_forward_plain
from founddiff_tpu_torch.ops.selective_scan import selective_scan
from founddiff_tpu_torch.parallel import (
    Mesh,
    apply_prefix,
    local_summary,
    make_mesh,
    seq_sharded_selective_scan,
)
from founddiff_tpu_torch.pipeline import make_volume_denoiser
from founddiff_tpu_torch.train.trainer import Trainer
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DIM, MULTS, SIZE = 8, (1, 2), 16
# the micro Dose-CLIP tower of tests/torch_parity.py (repeated here: that
# module imports JAX, and the ranks import this one)
MICRO_CLIP = (("vision_layers", (1, 1, 1, 1)), ("vision_width", 8), ("embed_dim", 64),
              ("transformer_width", 32), ("transformer_layers", 2),
              ("transformer_heads", 4), ("backbone_resolution", 64))
JOB_SECONDS = 240  # the 2-rank job's limit; past it the ranks are killed
VOLUME_Z = 3


def _scan_args(seed, B=4, K=2, L=32, D=8, N=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, K, L, D).astype(np.float32),
            (rng.randn(B, K, L, D) * 0.5).astype(np.float32),
            -np.abs(rng.randn(K, D, N)).astype(np.float32),
            rng.randn(B, K, L, N).astype(np.float32),
            rng.randn(B, K, L, N).astype(np.float32),
            rng.randn(K, D).astype(np.float32),
            (rng.randn(K, D) * 0.1).astype(np.float32))


# --- row 4's last state and the sharded scan ----------------------------------


@pytest.mark.parametrize("L,N", [(64, 4), (37, 12)])
def test_h_last_against_jax(L, N):
    """``scan_forward_plain(..., last_state=True)`` and ``selective_scan(...,
    return_last_state=True)`` against ``selective_scan_chunked(...,
    return_last_state=True)`` of JAX; y beside it."""
    from founddiff_tpu.ops.selective_scan import selective_scan_chunked as jchunked
    from torch_parity import jit_quick

    args = _scan_args(1, B=2, K=4, L=L, D=16, N=N)
    y_want, h_want = jit_quick(lambda *a: jchunked(*a, return_last_state=True))(*args)
    t = [torch.from_numpy(a) for a in args]
    y, hb, h_last = scan_forward_plain(*t, scan_chunk(N), last_state=True)
    y2, h_last2 = selective_scan(*t, return_last_state=True)
    assert h_last.shape == h_last2.shape == (2, 4, 16, N) and h_last.dtype == torch.float32
    for got in (h_last, h_last2):
        np.testing.assert_allclose(got.numpy(), np.asarray(h_want), rtol=1e-4, atol=1e-5)
    for got in (y, y2):
        np.testing.assert_allclose(got.numpy(), np.asarray(y_want), rtol=1e-4, atol=1e-5)
    # the bounds are those of the mode without the last state
    assert torch.equal(hb, scan_forward_plain(*t, scan_chunk(N))[1])


@pytest.mark.parametrize("data,seq", [(4, 2), (2, 4), (1, 8)])
def test_sharded_scan_against_jax(data, seq):
    """``local_summary`` per shard, the summaries stacked as the all-gather
    stacks them, ``apply_prefix`` per shard: against the JAX
    ``seq_sharded_selective_scan`` over a (data, seq) mesh of the CPU
    devices."""
    import jax.numpy as jnp

    from founddiff_tpu.parallel import make_mesh as jmake_mesh
    from founddiff_tpu.parallel import seq_sharded_selective_scan as jsharded
    from torch_parity import jit_quick

    args = _scan_args(seq)
    jmesh = jmake_mesh(data=data, seq=seq)
    want = np.asarray(jit_quick(lambda *a: jsharded(*a, mesh=jmesh, impl="chunked"))(
        *map(jnp.asarray, args)))
    u, delta, A, Bm, Cm, Ds, bias = map(torch.from_numpy, args)
    Ll = u.shape[2] // seq
    part = lambda t, i: t[:, :, i * Ll:(i + 1) * Ll]
    shards = [local_summary(part(u, i), part(delta, i), A, part(Bm, i), part(Cm, i), Ds, bias)
              for i in range(seq)]
    all_Ap = torch.stack([s[1] for s in shards])
    all_he = torch.stack([s[2] for s in shards])
    got = torch.cat([apply_prefix(s[0], s[3], part(Cm, i), A, all_Ap, all_he, i, chunk=3)
                     for i, s in enumerate(shards)], dim=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    # one rank: the whole scan
    one = seq_sharded_selective_scan(u, delta, A, Bm, Cm, Ds, bias, mesh=make_mesh())
    np.testing.assert_allclose(one.numpy(), want, rtol=2e-4, atol=2e-5)


def test_indivisible_length_raises():
    u, delta, A, Bm, Cm, Ds, bias = map(torch.from_numpy, _scan_args(0, L=30))
    with pytest.raises(ValueError, match="does not split"):
        seq_sharded_selective_scan(u, delta, A, Bm, Cm, Ds, bias, mesh=Mesh(1, 4))
    with pytest.raises(ValueError, match="mesh 3x1"):
        make_mesh(data=3)


# --- the volume denoiser ------------------------------------------------------


class _ConstantResidual:
    """``tests/test_volume.py``'s stub: a perfect model of residual 0.2."""

    def encode(self, x):
        return torch.zeros(x.shape[0], 1024), torch.zeros(x.shape[0], 1, 256)

    def __call__(self, x, time, x_self_cond=None, dose_embedding=None,
                 content_embedding=None):
        return [torch.full_like(x[..., :1], 0.2)]


def test_volume_denoiser_constant_residual():
    from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion

    diffusion = ResidualDiffusion(None, image_size=16, channels=1, timesteps=10,
                                  sampling_timesteps=2, objective="pred_res", loss_type="l2",
                                  condition=True, sum_scale=0.01, test_res_or_noise="res",
                                  device="cpu")
    denoise = make_volume_denoiser(_ConstantResidual(), diffusion, make_mesh(),
                                   batch_per_device=4)
    out = denoise(torch.full((10, 16, 16, 1), 0.7))  # 3 waves of 4, 2 slices of padding
    assert out.shape == (10, 16, 16, 1)
    # x_start = norm(0.7) - 0.2, unnormalised 0.6
    np.testing.assert_allclose(out.numpy(), 0.6, rtol=1e-4, atol=1e-4)


def _port_config(tower: bool) -> Config:
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.model.use_dose_encoder = tower
    cfg.diffusion.image_size = SIZE
    cfg.diffusion.timesteps, cfg.diffusion.sampling_timesteps = 20, 2
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(tower: bool):
    """The micro JAX model and its params: the port's seeded init carried
    into the JAX tree by the JAX converter, adaLN and prompt perturbed (as
    ``tests/test_torch_eval.py`` makes them)."""
    import jax
    import jax.numpy as jnp

    from founddiff_tpu.models import UnetRes as JUnetRes
    from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
    from founddiff_tpu.utils.torch_convert import convert_denoiser_params
    from torch_parity import perturb

    kw = dict(dim=DIM, dim_mults=MULTS, objective="pred_res", test_res_or_noise="res",
              scan_impl="chunked")
    jm = (JFoundDiff(**kw, clip_overrides=MICRO_CLIP) if tower
          else JUnetRes(**kw, channels=1, num_unet=1, condition=True))
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(7), x0, time0)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, model = build(_port_config(tower), device="cpu", seed=7, clip_overrides=MICRO_CLIP)
    state = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    params, _, missing = convert_denoiser_params(
        state, template, num_res=len(MULTS), with_dose_encoder=tower,
        clip_vision_layers=(1, 1, 1, 1), clip_transformer_layers=2)
    assert missing == []
    return jm, perturb(params, seed=7)


def _port_state(tower: bool) -> dict:
    from founddiff_tpu_torch.utils.convert import from_jax_params

    return from_jax_params(_jax_model(tower)[1])


def _port_founddiff(state):
    """The micro FoundDiff of the port with ``state`` and its diffusion."""
    diffusion, model = build(_port_config(True), device="cpu", clip_overrides=MICRO_CLIP)
    model.load_state_dict(state, strict=True)
    return diffusion, model


def _volume(seed=5):
    return np.random.default_rng(seed).random((VOLUME_Z, SIZE, SIZE, 1), dtype=np.float32)


def test_volume_denoiser_against_jax(monkeypatch):
    """Z 3 in waves of 2 (one slice of padding) at mesh (1, 1), fed the
    normals of the JAX keys (one per wave split from the key, the sampler's
    draw from its second half) against the JAX ``make_volume_denoiser`` on
    one CPU device."""
    import jax
    import jax.numpy as jnp

    from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
    from founddiff_tpu.parallel import make_mesh as jmake_mesh
    from founddiff_tpu.pipeline import make_volume_denoiser as jvolume
    from torch_parity import _QUICK_COMPILE

    jm, params = _jax_model(True)
    jd = JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s), image_size=SIZE,
                    timesteps=20, sampling_timesteps=2, objective="pred_res", loss_type="l2",
                    condition=True, sum_scale=0.01, test_res_or_noise="res")
    real_jit = jax.jit

    def quick_jit(fn, **kw):  # every wave has one shape: compile once, quickly
        done = []

        def call(*args):
            if not done:
                done.append(real_jit(fn, **kw).lower(*args).compile(_QUICK_COMPILE))
            return done[0](*args)

        return call

    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", quick_jit)
        jdenoise = jvolume(jm, jd, jmake_mesh(data=1, seq=1, devices=jax.devices()[:1]),
                           batch_per_device=2)
    vol = _volume()
    want = np.asarray(jdenoise(params, jax.random.PRNGKey(0), jnp.asarray(vol)))
    rng, noise = jax.random.PRNGKey(0), []
    for _ in range(2):
        rng, srng = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(jax.random.split(srng)[1], (2, SIZE, SIZE, 1)))))

    diffusion, model = _port_founddiff(_port_state(True))
    got = make_volume_denoiser(model, diffusion, make_mesh(), batch_per_device=2)(
        torch.from_numpy(vol), noise=noise)
    assert got.shape == (VOLUME_Z, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-3)


# --- the 2-rank job -----------------------------------------------------------


def _dp_config(mp: str) -> Config:
    """``test_dp_train_step_matches_single_device``'s model, 2 x 2 microbatches."""
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.model.use_dose_encoder = False
    cfg.diffusion.image_size = 8
    cfg.diffusion.timesteps, cfg.diffusion.sampling_timesteps = 10, 2
    cfg.train.train_batch_size, cfg.train.gradient_accumulate_every = 2, 2
    cfg.train.mixed_precision = mp
    return cfg


def _dp_batch():
    rng = np.random.RandomState(0)
    gt = rng.rand(4, 8, 8, 1).astype(np.float32)
    return gt, np.clip(gt + 0.1, 0, 1).astype(np.float32)


def _dp_step(mp: str, folder: str, mesh=None):
    """One ``train_step`` of :func:`_dp_config` (seed 3, adaLN drawn from
    N(0, 0.02)): ``(loss, {name: parameter after the step}, {name: its
    clipped gradient})``."""
    cfg = _dp_config(mp)
    cfg.train.checkpoint_folder = folder
    diffusion, model = build(cfg, device="cpu", seed=3, train=True)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    trainer = Trainer(diffusion, model, cfg, mesh=mesh)
    loss = trainer.train_step(_dp_batch())
    named = list(model.named_parameters())
    return (loss[0], {n: p.detach().clone() for n, p in named},
            {n: p.grad.clone() for n, p in named if p.grad is not None})


def _volume_out(state, mesh):
    diffusion, model = _port_founddiff(state)
    denoise = make_volume_denoiser(model, diffusion, mesh, batch_per_device=1)
    return denoise(torch.from_numpy(_volume()), generator=torch.Generator().manual_seed(11))


def _rank_main(rank: int, work: str) -> None:
    """One rank of the job: gloo over a ``FileStore``; writes
    ``rank<r>.pt`` with its results, or ``rank<r>.err`` with the traceback."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from founddiff_tpu_torch.parallel import init_distributed

        store = dist.FileStore(os.path.join(work, "store"), 2)
        init_distributed("cpu", rank=rank, world_size=2, store=store)
        out = {}
        # the UNet forward, every SS2D over a seq group of 2
        inputs = torch.load(os.path.join(work, "unet_inputs.pt"))
        unet = UnetRes(DIM, MULTS, condition=True, objective="pred_res",
                       test_res_or_noise="res")
        unet.load_state_dict(torch.load(os.path.join(work, "unet.pt")), strict=True)
        sharded = unet.eval().clone(mesh=make_mesh(data=1, seq=2))
        with torch.no_grad():
            out["unet"] = sharded(inputs["x"], [inputs["t"], inputs["t"]],
                                  dose_embedding=inputs["dose"],
                                  content_embedding=inputs["content"])[0]
        # one data-parallel train step at mesh (2, 1)
        dp = make_mesh(data=2)
        for mp in ("no", "bf16"):
            out[f"dp_{mp}"] = _dp_step(mp, os.path.join(work, f"dp{rank}"), mesh=dp)
        # the volume denoiser at meshes (2, 1) and (1, 2)
        state = torch.load(os.path.join(work, "founddiff.pt"))
        for data, seq in ((2, 1), (1, 2)):
            out[f"volume_{data}x{seq}"] = _volume_out(state, make_mesh(data=data, seq=seq))
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX expectations and the one-process references written, then the
    2-rank job run once; returns the references and each rank's results."""
    import jax.numpy as jnp

    from torch_parity import jit_quick

    work = str(tmp_path_factory.mktemp("ranks"))
    jm, params = _jax_model(False)
    rng = np.random.RandomState(3)
    x = rng.randn(2, SIZE, SIZE, 2).astype(np.float32)
    dose = rng.randn(2, 1024).astype(np.float32)
    content = rng.randn(2, 1, 256).astype(np.float32)
    t = jnp.full((2,), 5.0, jnp.float32)
    unet_want = np.asarray(jit_quick(lambda p, x_: jm.apply(
        {"params": p}, x_, [t, t], dose_embedding=dose, content_embedding=content)[0])(
            params, jnp.asarray(x)))
    torch.save(_port_state(False), os.path.join(work, "unet.pt"))
    torch.save({"x": torch.from_numpy(x), "t": torch.full((2,), 5.0),
                "dose": torch.from_numpy(dose), "content": torch.from_numpy(content)},
               os.path.join(work, "unet_inputs.pt"))
    state = _port_state(True)
    torch.save(state, os.path.join(work, "founddiff.pt"))

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, work)) for r in range(2)]
    for p in procs:
        p.start()
    # the references of one process, while the ranks run
    refs = {f"dp_{mp}": _dp_step(mp, os.path.join(work, "dp_one")) for mp in ("no", "bf16")}
    refs["volume"] = _volume_out(state, make_mesh())
    refs["unet"] = unet_want
    deadline = time.monotonic() + JOB_SECONDS
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work))
              if f.endswith(".err")]
    assert not hung, f"the 2-rank job did not end within {JOB_SECONDS} s"
    assert not errors and all(p.exitcode == 0 for p in procs), errors
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(2)]
    return refs, ranks


def test_seq_sharded_unet_forward_against_jax(job):
    """Every rank's output of the UNet whose SS2D scans split over the seq
    group of 2, against the JAX unsharded forward."""
    refs, ranks = job
    for out in ranks:
        np.testing.assert_allclose(out["unet"].numpy(), refs["unet"], rtol=2e-4, atol=2e-5)


# per parameter, ||g - g_one|| <= GRAD_TOL * ||g_one|| + 1e-6 (the rule of
# torch_parity.check_param_grads).  bf16: each rank rounds its one-row
# weight gradients to bf16 (8 bits), one process its two-row sums, before
# the fp32 sum; the worst parameter measured 6.4e-3
GRAD_TOL = {"no": 1e-3, "bf16": 2e-2}
ADAM_EPS = 1e-8  # train/state.py's Adam


def _rounding_only(cfg: Config) -> set:
    """The parameters whose gradient is zero analytically: the bias of each
    conv ahead of a GroupNorm of one channel a group, which the norm takes
    out again with the channel's mean."""
    _, model = build(cfg, device="cpu", seed=3, train=True)
    return {f"{name}.proj.bias" for name, m in model.named_modules()
            if isinstance(m, Block) and m.norm.num_groups == m.norm.num_channels}


@pytest.mark.parametrize("mp", ["no", "bf16"])
def test_dp_train_step_matches_one_process(job, mp):
    """The step at mesh (2, 1), each rank on its rows of every microbatch
    with the global draws, against one process on the global batch: the
    loss within 1e-5, the averaged and clipped gradients, and the
    parameters after the step within rtol 5e-4 / atol 1e-5.  Adam's first
    step moves an element by lr * g / (|g| + eps), about lr * sign(g), so in
    bf16, where a gradient within the rounding of zero can take either sign,
    at most 1 element in 1000 may differ instead by up to 2 lr (the two
    found at this seed: 2 of 784 in ``init_conv.weight``).  In fp32 the same
    budget holds only for the parameters of :func:`_rounding_only`, whose
    gradient is rounding of either sign on both sides, asserted below
    Adam's eps."""
    refs, ranks = job
    loss_one, params_one, grads_one = refs[f"dp_{mp}"]
    cfg = _dp_config(mp)
    lr = cfg.train.train_lr
    zero = _rounding_only(cfg)
    assert zero, "the model has no conv ahead of a one-channel-group GroupNorm"
    for out in ranks:
        loss, params, grads = out[f"dp_{mp}"]
        assert abs(loss - loss_one) <= 1e-5, (loss, loss_one)
        assert params.keys() == params_one.keys() and grads.keys() == grads_one.keys()
        for name, g in grads.items():
            err, ref = float((g - grads_one[name]).norm()), float(grads_one[name].norm())
            assert err <= GRAD_TOL[mp] * ref + 1e-6, (name, err, ref)
        flipped = total = 0
        for name, p in params.items():
            diff = (p - params_one[name]).abs()
            tol = 1e-5 + 5e-4 * params_one[name].abs()
            if mp == "no" and name not in zero:
                assert bool((diff <= tol).all()), (name, float(diff.max()))
            else:
                if mp == "no":
                    rounding = max(float(grads[name].abs().max()),
                                   float(grads_one[name].abs().max()))
                    assert rounding < ADAM_EPS, (name, rounding)
                assert bool((diff <= tol + 2 * lr).all()), (name, float(diff.max()))
                flipped += int((diff > tol).sum())
            total += p.numel()
        assert flipped <= total // 1000, (flipped, total)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_volume_denoiser_across_meshes(job, shape):
    """The volume denoised at mesh (2, 1) (slices split over data) and (1, 2)
    (every scan split over seq) on the same generator: every rank holds the
    volume of mesh (1, 1)."""
    refs, ranks = job
    for out in ranks:
        got = out[f"volume_{shape}"]
        assert got.shape == (VOLUME_Z, SIZE, SIZE, 1)
        np.testing.assert_allclose(got.numpy(), refs["volume"].numpy(), rtol=2e-4, atol=0)


# --- the command line and the tools -------------------------------------------


def test_cli_mesh_data_one(tmp_path, monkeypatch):
    """``--mesh_data 1`` in one process: a (1, 1) mesh handed to the
    ``Trainer``, two steps on a synthetic Mayo-2020 tree."""
    import test_data
    from founddiff_tpu_torch import cli

    root = str(tmp_path / "mayo")
    test_data._write_tree(root, phase="train512")
    test_data._write_tree(root, phase="test", n=4)
    monkeypatch.chdir(tmp_path)
    trainer = cli.main(["--name", "smoke", "--is_train", "--debug", "--data_root", root,
                        "--train_num_steps", "2", "--train_batch_size", "1",
                        "--image_size", "16", "--dim", "8", "--dim_mults", "1,2",
                        "--no_dose_encoder", "--device", "cpu", "--mesh_data", "1"])
    assert trainer.mesh is not None and trainer.mesh.shape == {"data": 1, "seq": 1}
    assert trainer.step == 2 and trainer.is_main


@pytest.mark.parametrize("tool", ["denoise_volume", "distributed_env"])
def test_tool_help(tool, capsys):
    import importlib

    main = importlib.import_module(f"founddiff_tpu_torch.tools.{tool}").main
    with pytest.raises(SystemExit) as done:
        main(["--help"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out
    assert ("--checkpoint" in out and "Orbax" in out) if tool == "denoise_volume" \
        else "--template" in out


@pytest.mark.parametrize("entry", ["cli", "denoise_volume", "distributed_env"])
def test_entry_points_refuse_the_cpu_by_default(entry, tmp_path, monkeypatch):
    """Without ``--device cpu`` the command line and both tools ask for the
    card, and on a host without one they raise rather than run on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    np.save(tmp_path / "vol.npy", np.zeros((1, 8, 8), np.float32))
    argv = {"cli": ["--name", "x", "--mesh_data", "1"],
            "denoise_volume": [str(tmp_path / "vol.npy"), str(tmp_path / "out.npy"),
                               "--checkpoint", str(tmp_path / "model-1.pt")],
            "distributed_env": []}[entry]
    module = "founddiff_tpu_torch.cli" if entry == "cli" else f"founddiff_tpu_torch.tools.{entry}"
    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(module).main(argv)
    assert not (tmp_path / "out.npy").exists()


def test_denoise_volume_tool(tmp_path, capsys):
    """``Config()`` at 16^2 on the CPU: a ``model-1.pt`` in the reference
    layout with the online weights alone (``load_torch`` takes them for the
    EMA too), a 4-slice volume in waves of 2; the JAX tool's summary line."""
    from founddiff_tpu_torch.tools import denoise_volume

    cfg = Config()
    cfg.diffusion.image_size = SIZE
    _, model = build(cfg, device="cpu")
    ckpt = str(tmp_path / "model-1.pt")
    torch.save({"model": {f"model.{k}": v for k, v in model.state_dict().items()}}, ckpt)
    del model
    np.save(tmp_path / "vol.npy", np.random.default_rng(0).random((4, SIZE, SIZE),
                                                                 dtype=np.float32))
    out = tmp_path / "out.npy"
    denoise_volume.main([str(tmp_path / "vol.npy"), str(out), "--checkpoint", ckpt,
                         "--batch_per_device", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"denoised 4 slices @ {SIZE}^2 in ") and "slices/s" in line
    assert "over mesh {'data': 1, 'seq': 1}" in line
    got = np.load(out)
    assert got.shape == (4, SIZE, SIZE) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
