"""The port's Dose-CLIP trainer (``founddiff_tpu_torch/tools/train_doseclip.py``,
CPU) against the JAX tool's step, assembled here from the same pieces as
``tools/train_doseclip.py:120-163`` (``CLIPIQA.apply``, ``bmc_loss``, optax
``multi_transform`` of ``adam`` and ``set_to_zero``), on a micro CLIPIQA at
shared weights (its batch-norm statistics set from data) and fixed batches
(two views of each slice, the second flipped):

- the loss and its three terms within 1e-5 relative;
- the gradients of step 1 of every trained tensor (``ctx``, ``token_prefix``,
  ``token_suffix``, both heads) within 1e-4 relative (norm);
- after 3 steps, the change of every trained tensor within 1e-3 relative
  (norm), the towers unchanged on both sides;
- the command line on a small synthetic tree with ``--device cpu`` (2 steps,
  bs 2): a file that loads strictly into ``CLIPIQA``;
- ``--clip_weights`` on the fixture vocabulary, whose prompts end at (25,
  28), refused with the JAX tool's message.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from founddiff_tpu.models.clip import CLIPIQA as JCLIPIQA
from founddiff_tpu.models.tokenizer import ClipTokenizer as JTokenizer
from founddiff_tpu.models.tokenizer import bootstrap_prompt_learner as j_bootstrap
from founddiff_tpu.ops.losses import bmc_loss as j_bmc_loss
from founddiff_tpu_torch.models.clip import CLIPIQA
from founddiff_tpu_torch.tools import train_doseclip as tool
from founddiff_tpu_torch.utils.convert import from_jax_params
from torch_parity import MICRO_CLIP, _QUICK_COMPILE, calibrated_micro_clipiqa
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(__file__))
from test_data import _write_tree  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bpe_tiny_vocab.txt.gz")
LR, SIGMA, SIZE = 1e-3, 1.0, 32


def _views(rng, n):
    """Slices of distinct mean levels, and the second view a flip of the
    first, as the dataset's augmentations pair them."""
    level = rng.random((n, 1, 1, 1)).astype(np.float32)
    v = (0.5 * level + 0.5 * rng.random((n, SIZE, SIZE, 1))).astype(np.float32)
    return v, np.flip(v, 2).copy()


@pytest.fixture(scope="module")
def micro():
    """Shared weights whose dose embeddings are well apart (the batch-norm
    statistics set from 8 slices); see ``calibrated_micro_clipiqa``."""
    _, jm, params = calibrated_micro_clipiqa(21, _views(np.random.default_rng(20), 8)[0], SIZE)
    return jm, params


def _port(params):
    model = CLIPIQA(**dict(MICRO_CLIP))
    model.load_state_dict(from_jax_params(params), strict=True)
    return model.eval()


def _batches(n, b=3):
    rng = np.random.default_rng(8)
    return [(_views(rng, b), np.float32(rng.choice([1, 2, 4, 10], b))) for _ in range(n)]


def _jax_loss(jm):
    """The JAX tool's ``loss_fn`` (train_doseclip.py:138-155)."""

    def loss_fn(params, batch):
        (v1, v2), labels = batch
        x1 = jnp.repeat(v1 * 2.0 - 1.0, 3, axis=-1)
        x2 = jnp.repeat(v2 * 2.0 - 1.0, 3, axis=-1)
        p1, d1, c1 = jm.apply({"params": params}, x1)
        p2, d2, c2 = jm.apply({"params": params}, x2)
        target = (1.0 / labels)[:, None]
        reg = jnp.mean((p1 - target) ** 2 + (p2 - target) ** 2)
        bmc = j_bmc_loss(d1, d2, jnp.asarray(SIGMA) ** 2)
        logits = c1 @ c2.T / 0.07
        idx = jnp.arange(c1.shape[0])
        nce = -jnp.mean(jax.nn.log_softmax(logits, axis=-1)[idx, idx])
        return reg + bmc + nce, {"reg": reg, "bmc": bmc, "nce": nce}

    return loss_fn


@pytest.fixture(scope="module")
def jax_grad(micro):
    """The JAX tool's loss and gradients, compiled once for both tests."""
    jm, params = micro
    fn = jax.jit(jax.value_and_grad(_jax_loss(jm), has_aux=True))
    return fn.lower(params, _batches(1)[0]).compile(_QUICK_COMPILE)


def _mask(params):
    return {k: (jax.tree_util.tree_map(lambda _: k != "clip_model", v)
                if isinstance(v, dict) else k != "clip_model") for k, v in params.items()}


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def test_loss_and_step_one_gradients(micro, jax_grad):
    _, params = micro
    batch = _batches(1)[0]
    (loss, aux), grads = jax_grad(params, batch)
    model = _port(params)
    trained = tool.freeze_towers(model)
    got, got_aux = tool.loss_fn(model, batch, SIGMA)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    for k in ("reg", "bmc", "nce"):
        assert abs(float(got_aux[k]) - float(aux[k])) <= 1e-5 * abs(float(aux[k])), k
    want = from_jax_params(grads)
    assert sorted(trained) == sorted(k for k in want if not k.startswith("clip_model."))
    for name, t in trained.items():
        assert _rel(t.grad, want[name]) <= 1e-4, name
    assert all(p.grad is None for p in model.clip_model.parameters())


def test_three_adam_steps(micro, jax_grad):
    _, params = micro
    batches = _batches(3)
    tx = optax.multi_transform({True: optax.adam(LR), False: optax.set_to_zero()},
                               _mask(params))
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    update = jax.jit(update)
    p, s = params, tx.init(params)
    for b in batches:
        _, g = jax_grad(p, b)
        p, s = update(g, s, p)
    before, after = from_jax_params(params), from_jax_params(p)
    model = _port(params)
    trained = tool.freeze_towers(model)
    opt = torch.optim.Adam(list(trained.values()), lr=LR, eps=1e-8)
    for b in batches:
        tool.step(model, opt, b, SIGMA)
    state = model.state_dict()
    for name, v in state.items():
        if name.startswith("clip_model."):
            assert torch.equal(v, before[name]) and torch.equal(after[name], before[name]), name
        else:
            want = after[name] - before[name]
            assert float(want.norm()) > 0, name
            assert _rel(v - before[name], want) <= 1e-3, name


def test_cli_on_a_synthetic_tree(tmp_path):
    root = str(tmp_path / "mayo")
    _write_tree(root, "train512", n=2, size=16)
    out = str(tmp_path / "out")
    model = tool.main(["--data_root", root, "--steps", "2", "--batch_size", "2", "--out", out,
                       "--device", "cpu"])
    assert all(not t.requires_grad for t in tool.trained_tensors(model).values())
    sd = torch.load(os.path.join(out, "dose_clip_final.pth"), weights_only=True)
    fresh = CLIPIQA()
    fresh.load_state_dict(sd, strict=True)
    assert "step 0: loss " in open(os.path.join(out, "train.log")).read()


def test_clip_weights_refused_on_the_fixture_vocabulary(tmp_path):
    table = np.random.default_rng(0).standard_normal((533, 512)).astype(np.float32)
    path = str(tmp_path / "clip.pt")
    torch.save({"token_embedding.weight": torch.from_numpy(table)}, path)
    _, eot, _ = j_bootstrap(table, JTokenizer(bpe_path=FIXTURE))
    assert eot == (25, 28)
    want = (f"tokenized prompt EOT positions {eot} != model config (24, 25); pass matching "
            "prompt_eot_indices to CLIPIQA")
    with pytest.raises(SystemExit) as e:
        tool.bootstrap_from_clip(CLIPIQA(**dict(MICRO_CLIP, transformer_width=512)), path,
                                 FIXTURE)
    assert str(e.value) == want
