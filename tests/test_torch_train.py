"""The port's training path (CPU, plain versions) against the JAX package.

- ``p_losses`` of every objective and loss type, with ``t`` and the noise
  drawn from the JAX package's own keys (residual.py:494-495, 558-559) and
  handed to the port, around a closed-form model;
- one microbatch's loss and per-parameter gradients of the micro FoundDiff
  of ``tests/test_torch_slice.py`` (JAX's gradient tree mapped to the port's
  names through ``from_jax_params``);
- clip + Adam + EMA fed identical gradients for 115 steps, across the EMA's
  ``update_after_step`` (100), against optax and ``founddiff_tpu.train.ema``;
  RAdam against optax ``radam`` for two UNets;
- a 2-step ``Trainer`` run with a checkpoint round trip;
- a bf16 step, in which the frozen Dose-CLIP tower computes in bf16 as the
  JAX step runs it (every fp32 param leaf cast, the tower's too).

Inputs are made with numpy from a seed; fp32.  Tolerances: rtol 1e-3 /
atol 1e-4 on losses, parameters and EMA buffers.  The UNet's parameter
gradients are held per parameter at ||g_port - g_jax|| <= 1e-3 ||g_jax|| +
1e-6 (relative norm): a gradient's entries span many orders of magnitude
through a UNet, so one absolute floor either hides the small ones or flags
fp32 reassociation in the large ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.models.founddiff import FoundDiffDenoiser as JFoundDiff
from founddiff_tpu.train import ema as jema
from founddiff_tpu.train.state import make_optimizer as j_make_optimizer
from founddiff_tpu.utils.torch_convert import convert_denoiser_params
from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion as TDiffusion
from founddiff_tpu_torch.factory import build
from founddiff_tpu_torch.models.clip import FrozenBatchNorm
from founddiff_tpu_torch.train.ema import ema_decay_schedule, ema_update
from founddiff_tpu_torch.train.state import clip_by_global_norm_, make_optimizer
from founddiff_tpu_torch.train.trainer import Trainer
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, jit_quick, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4
DIM, MULTS, SIZE = 32, (1, 4), 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The micro train steps are hundreds of small ops: with the test
    workers sharing the host's cores, PyTorch's intra-op threads contend
    for them and a 4 s test takes minutes, so this file runs on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _pair(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.random((b, SIZE, SIZE, 1)).astype(np.float32) for _ in range(2)]


def _jax_draws(rng, b, shape):
    """``t`` and the noise exactly as ``loss`` and ``p_losses`` draw them."""
    rng, t_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (b,), 0, 1000)
    _, noise_rng, _, _ = jax.random.split(rng, 4)
    noise = jax.random.normal(noise_rng, shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(t)).long(), t_(noise)


@pytest.mark.parametrize("objective", ["pred_res", "pred_noise", "pred_res_noise",
                                       "pred_x0_noise"])
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses(objective, loss_type):
    two = objective in ("pred_res_noise", "pred_x0_noise")

    def model(x_in, time):  # the same closed form on both sides
        a = x_in[..., :1] * 0.7 - x_in[..., 1:2] * 0.2 + time[0][:, None, None, None] * 1e-3
        return [a, x_in[..., :1] * 0.3 + time[1][:, None, None, None] * 1e-2] if two else [a]

    kw = dict(image_size=SIZE, timesteps=1000, sampling_timesteps=2, loss_type=loss_type,
              objective=objective, condition=True, sum_scale=0.01, test_res_or_noise="res")
    jd = JDiffusion(lambda p, x, t, s=None: model(x, t), **kw)
    td = TDiffusion(lambda x, t, s=None: model(x, t), **kw, device="cpu")
    imgs = _pair(3)
    rng = jax.random.PRNGKey(5)
    want = jd.loss(None, rng, [jnp.asarray(i) for i in imgs])
    t, noise = _jax_draws(rng, 2, imgs[0].shape)
    got = td.loss([t_(i) for i in imgs], t=t, noise=noise)
    assert len(got) == len(want) == (2 if two else 1)
    for g, w in zip(got, want):
        _close(g, w)


def test_aux_losses_are_refused():
    with pytest.raises(NotImplementedError):
        TDiffusion(lambda *a: None, image_size=SIZE, aux_grad_loss_weight=0.1)


@pytest.fixture(scope="module")
def micro():
    """The micro JAX model and its params: the port's seeded init carried
    into the JAX tree by the JAX converter (the tree's shapes from
    ``eval_shape``, which compiles nothing), adaLN and prompt perturbed."""
    jm = JFoundDiff(dim=DIM, dim_mults=MULTS, scan_impl="chunked", clip_overrides=MICRO_CLIP)
    x0, time0 = jnp.zeros((1, SIZE, SIZE, 2)), [jnp.zeros((1,)), jnp.zeros((1,))]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(4), x0, time0)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, model = build(_micro_config(), device="cpu", seed=4, clip_overrides=MICRO_CLIP)
    state = {"model." + k: v.numpy() for k, v in model.state_dict().items()}
    params, _, missing = convert_denoiser_params(
        state, template, num_res=len(MULTS), clip_vision_layers=(1, 1, 1, 1),
        clip_transformer_layers=2)
    assert missing == []
    return jm, perturb(params, seed=4)


def _micro_config(**train):
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = DIM, MULTS
    cfg.diffusion.image_size = SIZE
    cfg.train = dataclasses.replace(cfg.train, **train)
    return cfg


def _port(jax_params, **train):
    cfg = _micro_config(**train)
    diffusion, model = build(cfg, device="cpu", clip_overrides=MICRO_CLIP, train=True)
    model.load_state_dict(from_jax_params(jax_params), strict=True)
    return cfg, diffusion, model


def test_build_train_freezes_only_the_tower(micro):
    _, _, model = _port(micro[1])
    assert model.training and not model.dose_encoder.training
    for name, p in model.named_parameters():
        assert p.requires_grad == (".dose_encoder." not in name), name


def test_microbatch_loss_and_parameter_gradients(micro):
    """One microbatch of the train step: loss and d(loss)/d(param) for every
    trainable parameter, the tower's gradient being 0 in JAX and absent in
    the port."""
    jm, params = micro
    jd = JDiffusion(lambda p, x, t, s=None: jm.apply({"params": p}, x, t, s),
                    image_size=SIZE, timesteps=1000, sampling_timesteps=2, loss_type="l2",
                    objective="pred_res", condition=True, sum_scale=0.01,
                    test_res_or_noise="res")
    imgs = _pair(7)
    rng = jax.random.PRNGKey(9)
    loss_j, grads_j = jit_quick(jax.value_and_grad(
        lambda p: sum(jd.loss(p, rng, [jnp.asarray(i) for i in imgs]))))(params)
    _, diffusion, model = _port(params)
    t, noise = _jax_draws(rng, 2, imgs[0].shape)
    loss_t = sum(diffusion.loss([t_(i) for i in imgs], t=t, noise=noise))
    _close(loss_t, loss_j)
    loss_t.backward()
    want = from_jax_params(grads_j)
    checked = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert float(want[name].abs().max()) == 0.0, name
            continue
        g, w = p.grad, want[name]
        assert g is not None, name
        err = float((g - w).norm())
        assert err <= 1e-3 * float(w.norm()) + 1e-6, (name, err, float(w.norm()))
        checked += 1
    assert checked > 100


def _tree(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def _optimizer_run(num_unet, steps, lr):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tx = j_make_optimizer(num_unet=num_unet, lr=lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    ema_j = jema.EmaState.create(jp)
    tp = {k: torch.nn.Parameter(t_(v)) for k, v in params.items()}
    opt = make_optimizer(tp.values(), num_unet=num_unet, lr=lr)
    ema_t = {k: v.detach().clone() for k, v in tp.items()}
    ema_step = 0
    for step in range(steps):
        # global norms from about 0.3 to 3: some steps clip, some do not
        grads = jax.tree_util.tree_map(lambda v: v * (0.1 + step % 7 * 0.2), _tree(rng))
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       jp)
        jp = optax.apply_updates(jp, updates)
        ema_j = jema.ema_update(ema_j, jp)
        for k, p in tp.items():
            p.grad = t_(grads[k])
        clip_by_global_norm_(tp.values(), 1.0)
        opt.step()
        ema_step = ema_update(list(ema_t.values()), list(tp.values()), ema_step)
    return jp, ema_j, tp, ema_t, ema_step


def test_clip_adam_ema_across_update_after_step():
    jp, ema_j, tp, ema_t, ema_step = _optimizer_run(num_unet=1, steps=115, lr=1e-2)
    assert ema_step == int(ema_j.step) == 115
    for k in tp:
        _close(tp[k], jp[k], k)
        _close(ema_t[k], ema_j.params[k], "ema " + k)
    for s in (0, 99, 100, 101, 102, 110, 500, 10 ** 6):
        assert ema_decay_schedule(s) == pytest.approx(
            float(jema.ema_decay_schedule(jnp.asarray(s, jnp.int32))), rel=1e-6, abs=1e-7)


def test_radam_for_two_unets():
    jp, _, tp, _, _ = _optimizer_run(num_unet=2, steps=20, lr=1e-2)
    for k in tp:
        _close(tp[k], jp[k], k)


def test_clip_is_optax_not_clip_grad_norm():
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])  # norm 5
    clip_by_global_norm_([p], 1.0)
    want = optax.clip_by_global_norm(1.0).update({"g": jnp.array([3.0, 4.0, 0, 0])}, None)[0]
    _close(p.grad, want["g"])
    p.grad = torch.tensor([0.3, 0.4, 0.0, 0.0])  # below the limit: unchanged
    clip_by_global_norm_([p], 1.0)
    np.testing.assert_array_equal(p.grad.numpy(), np.float32([0.3, 0.4, 0, 0]))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.random((4, SIZE, SIZE, 1)).astype(np.float32))
                  for _ in range(2)) for _ in range(n)]


def test_trainer_two_steps_and_checkpoint_round_trip(micro, tmp_path):
    cfg, diffusion, model = _port(micro[1], train_num_steps=2,
                                  checkpoint_folder=str(tmp_path), seed=3)
    trainer = Trainer(diffusion, model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step(_batches(1, 1)[0])
    after_one = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train(_batches(3, 1), log_every=1)  # the loop takes one more step
    assert trainer.step == 2 and trainer.ema_step == 2
    log = (tmp_path / "train.log").read_text()
    assert "step 2/2 loss_unet0: " in log and "training complete" in log
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert changed and not any(".dose_encoder." in k for k in changed)
    # EMA counter 0 copies (decay 0); counter 1 is not a multiple of 10
    for k, v in trainer.ema.state_dict().items():
        assert torch.equal(v, after_one[k]), k
    x01 = _batches(1, 5)[0][1][:1]
    sample = trainer.sample(x01, generator=torch.Generator().manual_seed(0))
    assert sample.shape == x01.shape and torch.isfinite(sample).all()
    path = trainer.save(1)
    data = torch.load(path, weights_only=True)
    assert set(data) == {"step", "model", "opt", "ema"}
    assert all(k.startswith("model.unet0.") for k in data["model"])
    assert "ema_model.model.unet0.init_conv.weight" in data["ema"]

    cfg2, diffusion2, model2 = _port(micro[1], checkpoint_folder=str(tmp_path), seed=3)
    restored = Trainer(diffusion2, model2, cfg2)
    restored.load(1)
    assert restored.step == 2 and restored.ema_step == 2
    for a, b in ((model, model2), (trainer.ema, restored.ema)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    # the optimizer state came back too: one more step agrees exactly
    batch = _batches(1, 2)[0]
    trainer.generator.manual_seed(11)
    restored.generator.manual_seed(11)
    assert trainer.train_step(batch) == restored.train_step(batch)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k


def test_trainer_bf16_step(micro, tmp_path):
    """``mixed_precision="bf16"``: bf16 copies of the fp32 masters at the model
    boundary; the loss is near the fp32 loss and the masters move, in fp32."""
    losses = {}
    for mp in ("no", "bf16"):
        cfg, diffusion, model = _port(micro[1], mixed_precision=mp, seed=3,
                                      checkpoint_folder=str(tmp_path))
        trainer = Trainer(diffusion, model, cfg)
        w = model.unet0.init_conv.weight
        w0 = w.detach().clone()
        losses[mp] = trainer.train_step(_batches(1, 4)[0])
        assert w.dtype == torch.float32 and not torch.equal(w.detach(), w0)
    # bf16 rounds the trunk's activations to 8 bits: 2% of the loss
    assert losses["bf16"][0] == pytest.approx(losses["no"][0], rel=2e-2)


def test_trainer_bf16_runs_the_tower_in_bf16(micro, tmp_path):
    """The JAX bf16 step casts every fp32 leaf of the param tree, the frozen
    tower's included, whose BatchNorm statistics and prompt embeddings are
    param leaves there (trainer.py:169-174): every convolution, linear and
    BatchNorm of the tower sees bf16 inputs and bf16 weights and statistics."""
    cfg, diffusion, model = _port(micro[1], mixed_precision="bf16", seed=3,
                                  checkpoint_folder=str(tmp_path))
    trainer = Trainer(diffusion, model, cfg)
    seen = []

    def record(mod, args):
        names = ("weight", "bias", "running_mean", "running_var")
        tensors = [args[0]] + [getattr(mod, n) for n in names if getattr(mod, n, None) is not None]
        seen.append((type(mod).__name__, {t.dtype for t in tensors}))

    hooked = (torch.nn.Conv2d, torch.nn.Linear, FrozenBatchNorm)
    handles = [m.register_forward_pre_hook(record) for m in model.dose_encoder.modules()
               if isinstance(m, hooked)]
    try:
        losses = trainer.train_step(_batches(1, 4)[0])
    finally:
        for h in handles:
            h.remove()
    assert np.isfinite(losses[0])
    assert {name for name, _ in seen} == {"Conv", "Dense", "FrozenBatchNorm"}
    assert all(dtypes == {torch.bfloat16} for _, dtypes in seen), seen
    assert all(p.dtype == torch.float32 for p in model.parameters())
