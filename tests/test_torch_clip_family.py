"""The port's CLIP family (CPU) against the JAX package: micro RN and ViT
CLIPs at shared weights.

- ``encode_image`` with the positional embedding off and on, at the tower's
  resolution and at one whose token count differs (the embedding resized);
  ``return_features``; ``encode_text``; the CLIP forward's logits and
  normalized image features;
- the resize helper against ``jax.image.resize`` (linear and cubic, up and
  down) at 1e-5 absolute;
- ``infer_clip_config`` equal to JAX's on the same synthetic state dicts,
  ``build_clip_from_state_dict`` loading strictly (a stock file's ints and
  BatchNorm step counters aside);
- ``from_jax_params`` covering every leaf of both trees.

Weights: the JAX trees from ``filled_params`` (BatchNorm variances made
positive), loaded into the port through ``from_jax_params``.  Tolerance:
rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models.clip import CLIP as JCLIP
from founddiff_tpu.utils import torch_convert as jconv
from founddiff_tpu_torch.models.clip import CLIP
from founddiff_tpu_torch.utils.clip_build import build_clip_from_state_dict, infer_clip_config
from founddiff_tpu_torch.utils.convert import from_jax_params
from founddiff_tpu_torch.utils.resize import resize
from torch_parity import filled_params, jit_quick, np_, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-3, 1e-4
VOCAB, CTX = 533, 77  # the fixture vocabulary's size
TEXT = dict(context_length=CTX, vocab_size=VOCAB, transformer_width=32, transformer_heads=4,
            transformer_layers=2)
FAMILIES = {
    "rn": dict(embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=8,
               **TEXT),
    "vit": dict(embed_dim=48, image_resolution=64, vision_layers=2, vision_width=64,
                vision_patch_size=16, **TEXT),
}
# a resolution whose token count differs from the tower's: 3 x 3 + 1 against
# 2 x 2 + 1 (RN), 5 x 5 + 1 against 4 x 4 + 1 (ViT)
OTHER_RES = {"rn": 96, "vit": 80}


def _positive_var(tree):
    return {k: (_positive_var(v) if isinstance(v, dict) else
                (np.abs(v) + 0.5).astype(np.float32) if k == "var" else v)
            for k, v in tree.items()}


def _ids(seed, b=3):
    """EOT (the largest id) at a different position in each row."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, CTX), np.int32)
    for i in range(b):
        n = 5 + 7 * i
        ids[i, 0] = VOCAB - 2
        ids[i, 1:n] = rng.integers(1, VOCAB - 2, n - 1)
        ids[i, n] = VOCAB - 1
    return ids


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    name = request.param
    cfg = FAMILIES[name]
    jm = JCLIP(**cfg)
    res = cfg["image_resolution"]
    params = _positive_var(filled_params(jm, 11, jnp.zeros((1, res, res, 3)),
                                         jnp.zeros((1, CTX), jnp.int32)))
    port = CLIP(**cfg)
    port.load_state_dict(from_jax_params(params), strict=True)
    return name, cfg, jm, params, port.eval()


def _image(seed, res, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_from_jax_params_covers_both_trees(family):
    _, cfg, _, params, port = family
    sd = from_jax_params(params)
    assert set(sd) == set(port.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    if isinstance(cfg["vision_layers"], int):
        assert "visual.transformer.resblocks.1.attn.in_proj_weight" in sd
        assert not any(k.startswith("visual.resblocks") for k in sd)
    assert sd["token_embedding.weight"].shape == (VOCAB, cfg["transformer_width"])


@pytest.mark.parametrize("pos,other", [(False, False), (True, False), (True, True)])
def test_encode_image(family, pos, other):
    name, cfg, jm, params, port = family
    res = OTHER_RES[name] if other else cfg["image_resolution"]
    x = _image(1, res)
    want = jit_quick(lambda p, x: jm.apply({"params": p}, x, pos_embedding=pos,
                                           method=JCLIP.encode_image))(params, x)
    with torch.no_grad():
        got = port.encode_image(t_(x), pos_embedding=pos)
    _close(got, want)


def test_return_features_and_tokens(family):
    name, cfg, jm, params, port = family
    x = _image(2, cfg["image_resolution"])
    key = "return_features" if name == "rn" else "return_token"

    def fn(p, x):
        return jm.apply({"params": p}, x, **{key: True},
                        method=lambda m, x, **k: m.visual(x, **k))

    want = jit_quick(fn)(params, x)
    with torch.no_grad():
        got = port.visual(t_(x), **{key: True})
    if name == "rn":
        _close(got, want)
    else:
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_encode_text_and_forward(family):
    _, cfg, jm, params, port = family
    ids = _ids(3)
    x = _image(4, cfg["image_resolution"], b=2)
    want_text = jit_quick(lambda p, t: jm.apply({"params": p}, t,
                                                method=JCLIP.encode_text))(params, ids)
    want_logits, want_feats = jit_quick(lambda p, x, t: jm.apply({"params": p}, x, t))(
        params, x, ids)
    with torch.no_grad():
        _close(port.encode_text(torch.from_numpy(ids).long()), want_text)
        logits, feats = port(t_(x), torch.from_numpy(ids).long())
    assert logits.shape == (2, 3)
    _close(logits, want_logits)
    _close(feats, want_feats)


@pytest.mark.parametrize("method", ["linear", "cubic", "bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", [((1, 1, 50, 16), (1, 1, 257, 16)),
                                     ((1, 1, 257, 16), (1, 1, 50, 16)),
                                     ((2, 40, 30, 3), (2, 17, 71, 3))])
def test_resize_against_jax(method, src, dst):
    x = np.random.default_rng(5).standard_normal(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
    got = resize(torch.from_numpy(x), dst, method).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _stock_state(port, extra=True):
    """The port's state dict as a stock file holds it: the three ints and,
    for the RN tower, a BatchNorm step counter per BatchNorm."""
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    if extra:
        sd.update(input_resolution=torch.tensor(224), context_length=torch.tensor(CTX),
                  vocab_size=torch.tensor(VOCAB))
        for k in list(sd):
            if k.endswith("running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def test_infer_config_and_build(family):
    name, cfg, _, _, port = family
    sd = _stock_state(port)
    for prefix in ("", "clip_model."):
        keyed = {prefix + k: v for k, v in sd.items()}
        got = infer_clip_config(keyed, prefix)
        want = jconv.infer_clip_config({k: v.numpy() for k, v in keyed.items()}, prefix)
        assert got == want
        # the head counts a state dict cannot hold, patched as in JAX
        built = build_clip_from_state_dict(keyed, prefix, transformer_heads=4)
        for k, v in port.state_dict().items():
            assert torch.equal(built.state_dict()[k], v), k
    assert isinstance(got["vision_layers"], tuple if name == "rn" else int)
    with pytest.raises(RuntimeError):  # strict: a missing tensor is an error
        build_clip_from_state_dict({k: v for k, v in sd.items() if "ln_final.bias" != k},
                                   transformer_heads=4)


@pytest.mark.parametrize("case", ["whole", "whole lacking one", "towers", "towers bare lacking one"])
def test_load_clipiqa(case):
    """``load_clipiqa``: a whole CLIPIQA state dict (the FID tool's load,
    which refuses one that lacks a tensor), or the CLIP towers of a CLIPIQA
    or bare CLIP one with its token embedding (the Dose-CLIP trainer's load,
    which keeps what the file lacks)."""
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.clip import CLIPIQA
    from founddiff_tpu_torch.utils.clip_build import load_clipiqa
    from torch_parity import MICRO_CLIP

    src, dst = CLIPIQA(**dict(MICRO_CLIP)), CLIPIQA(**dict(MICRO_CLIP))
    init_params(src, torch.Generator().manual_seed(1))
    init_params(dst, torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    sd = dict(src.state_dict())
    towers = case.startswith("towers")
    if towers:
        sd["clip_model.token_embedding.weight"] = torch.zeros(VOCAB, 32)
    if case.endswith("bare lacking one"):
        sd = {k[len("clip_model."):]: v for k, v in sd.items() if k.startswith("clip_model.")}
    dropped = "ln_final.bias" if towers else "clip_model.ln_final.bias"
    if case.endswith("lacking one"):
        del sd[dropped]
    if case == "whole lacking one":
        with pytest.raises(ValueError, match=r"^ckpt is missing 1 expected tensors"):
            load_clipiqa(dst, sd, source="ckpt")
        return
    missing = load_clipiqa(dst, sd, towers_only=towers, strict=not case.endswith("one"))
    assert missing == ([dropped] if case.endswith("one") else [])
    kept = {"clip_model.ln_final.bias"} if case.endswith("one") else set()
    for k, v in dst.state_dict().items():
        loaded = (k.startswith("clip_model.") or not towers) and k not in kept
        assert torch.equal(v, src.state_dict()[k] if loaded else before[k]), k
