"""The frozen reference against the port's CPU path at a tiny size, and its
independence: it imports nothing of the port, of JAX or of the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

from bench_h100.lib import build, data, weights
from bench_h100.reference import diffusion as RD
from bench_h100.reference import precision as P

from tiny import REPO, tiny_config

REFERENCE = os.path.join(REPO, "bench_h100", "reference")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REFERENCE) if f.endswith(".py")))
def test_reference_imports_only_torch_numpy_and_itself(name):
    for mod in _imports(os.path.join(REFERENCE, name)):
        top = mod.split(".")[0]
        assert mod.startswith(".") or top in {"torch", "numpy", "math", "contextlib",
                                               "contextvars", "collections", "__future__"}, mod


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import bench_h100.reference.model, "
            "bench_h100.reference.diffusion; print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'founddiff_tpu_torch', 'founddiff_tpu', 'jax', 'jaxlib', 'flax'}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("family", ["founddiff", "vanilla"])
def test_state_dicts_match(family):
    config = tiny_config("t", family)
    _, _, model = build.program(config, "cpu", train=False)
    ref = build.reference(config, "cpu")
    a = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    b = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert a == b


def _pair(family, seed=20241018, n=4):
    config = tiny_config("t", family)
    gen = torch.Generator().manual_seed(seed)
    gt, ld = data.ct_pairs(n, 32, gen, "cpu")
    st = build.state(config, seed, "cpu", ld[:2])
    return config, st, gt, ld, gen


def test_serving_matches_the_port():
    from founddiff_tpu_torch.pipeline import make_hoisted_sampler

    config, st, _, ld, gen = _pair("founddiff")
    _, diffusion, model = build.program(config, "cpu", train=False)
    model.load_state_dict(st)
    ref = build.reference(config, "cpu")
    ref.load_state_dict(st)
    noise = torch.randn(ld.shape, generator=gen)
    got = make_hoisted_sampler(model, diffusion)(ld, noise=noise)
    want, (dose, content) = RD.serve(ref, ld, noise)
    assert (got - want).abs().max() < 1e-6
    assert (want - ld).abs().mean() > 1e-2  # the UNet changed the slices
    gap = lambda a, b: float(max((p - r).abs().max() / r.abs().max() for p, r in zip(a, b)))
    program = gap(model.encode(ld.float() * 2 - 1), (dose, content))
    assert program < 1e-4
    # the fp8 trunk is far from both, and the TF32 tower's embeddings from the tower's
    assert (RD.serve(ref, ld, noise, trunk="fp8")[0] - want).square().mean().sqrt() > 1e-3
    _, tf32 = RD.serve(ref, ld, noise, tower="tf32")
    print("embedding gaps: program", program, "tf32 tower", gap(tf32, (dose, content)))
    assert gap(tf32, (dose, content)) > 10 * program


@pytest.mark.parametrize("family", ["founddiff", "vanilla"])
def test_train_steps_match_the_port(family):
    from founddiff_tpu_torch.train.trainer import Trainer

    config, st, gt, ld, _ = _pair(family, n=8)
    cfg, diffusion, model = build.program(config, "cpu", train=True, seed=77)
    model.load_state_dict(st)
    trainer = Trainer(diffusion, model, cfg)
    batches = [(gt[:4], ld[:4]), (gt[4:], ld[4:])]
    losses = [trainer.train_step(b)[0] for b in batches]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    ref = build.reference(config, "cpu")
    ref.load_state_dict(st)
    for n, p in ref.named_parameters():
        p.requires_grad_(n in names)
    out = RD.train_steps(ref, names, batches, 77, {"founddiff": "residual",
                                                   "vanilla": "gaussian"}[family],
                         2, 2e-4, (0.9, 0.99), 1.0)
    assert losses == pytest.approx(out["losses"], rel=1e-5)
    params = dict(model.named_parameters())
    ref_params = dict(ref.named_parameters())
    g = {n: float(out["grad1"][n].norm()) for n in names}
    med = sorted(g.values())[len(g) // 2]
    moved = [n for n in names if g[n] >= 1e-3 * med]  # the rest move by round-off alone
    assert len(moved) > len(names) // 2
    for n in moved:
        assert torch.allclose(params[n], ref_params[n], atol=2e-6), n


def test_tf32_rounding():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -10)])
    assert P.tf32_round(x).tolist() == [1.0, 1 + 2 ** -9, -(1 + 2 ** -10)]
    y = torch.randn(1000)
    assert ((P.tf32_round(y) - y).abs() <= y.abs() * 2 ** -11).all()
    w = torch.randn(10, requires_grad=True)
    with P.products("tf32"):
        P.linear(torch.ones(1, 10), w[None]).sum().backward()
    assert torch.equal(w.grad, torch.ones(10))  # straight through


def test_weights_are_seeded_and_no_layer_is_an_identity():
    config = tiny_config("t", "founddiff")
    ref = build.reference(config, "meta")
    a = weights.make_state(ref, 5, "cpu")
    b = weights.make_state(ref, 5, "cpu")
    c = weights.make_state(ref, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    for k, v in a.items():
        if "adaLN_modulation" in k or k.endswith("prompt"):
            assert v.abs().min() >= 0 and v.abs().max() > 0 and v.std() > 0, k
