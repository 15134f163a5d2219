"""CLIP and Dose-CLIP from stock state dicts (mirror of
``founddiff_tpu/utils/torch_convert.py:272-353`` and the checkpoint halves of
``tools/train_doseclip.py`` and ``fid_and_inception_score.py``).

The port names its parameters as the reference does, so a stock OpenAI CLIP
(RN or ViT), a ``Dose-CLIP.pth`` or a ``CLIPIQA`` state dict loads without a
conversion: :func:`build_clip_from_state_dict` infers the architecture from
the keys, as the reference's ``build_model`` does (src/DACLIP.py:609-648),
and loads strictly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from founddiff_tpu_torch.models.clip import CLIP, CLIPIQA

TOKEN_EMBEDDING = "token_embedding.weight"
# what a stock state dict holds beside the weights: the reference's build_model
# deletes the three ints (src/DACLIP.py:637-639); a BatchNorm's step counter
# has no use in an eval-mode affine
_NOT_WEIGHTS = ("input_resolution", "context_length", "vocab_size")


def _strip(state_dict: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)
            and k[len(prefix):] not in _NOT_WEIGHTS
            and not k.endswith(".num_batches_tracked")}


def infer_clip_config(state_dict: Mapping, prefix: str = "") -> dict:
    """The ``CLIP`` arguments of a stock CLIP state dict whose keys may carry
    ``prefix`` (``clip_model.``), by the reference's key inspection
    (src/DACLIP.py:609-633).  Head counts are width // 64, as the reference
    takes them."""
    sd = _strip(state_dict, prefix)
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
                              for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = 32
        image_resolution = out_width * 32
    width = sd["ln_final.weight"].shape[0]
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd[TOKEN_EMBEDDING].shape[0],
        transformer_width=width,
        transformer_heads=width // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


def build_clip_from_state_dict(state_dict: Mapping, prefix: str = "", **overrides) -> CLIP:
    """A ``CLIP`` of the state dict's architecture (:func:`infer_clip_config`,
    patched by ``overrides``: a state dict does not hold the head counts),
    its weights loaded strictly from the keys under ``prefix`` (the three
    ints and BatchNorm step counters of a stock file aside); on the CPU,
    float32, in eval mode."""
    cfg = infer_clip_config(state_dict, prefix)
    cfg.update(overrides)
    model = CLIP(**cfg)
    sd = {k: torch.as_tensor(v).float() for k, v in _strip(state_dict, prefix).items()}
    sd["logit_scale"] = sd["logit_scale"].reshape(())
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch state-dict file, on the CPU."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in data.items() if torch.is_tensor(v)}


def clip_prefix(state_dict: Mapping) -> str:
    """``"clip_model."`` for a CLIPIQA / Dose-CLIP file, ``""`` for a bare CLIP."""
    return "clip_model." if any(k.startswith("clip_model.") for k in state_dict) else ""


def load_clipiqa(tower: CLIPIQA, state_dict: Mapping, towers_only: bool = False,
                 strict: bool = True, source: str = "the state dict") -> list:
    """A torch state dict into ``tower``: a whole ``CLIPIQA`` / Dose-CLIP one,
    as the JAX FID tool loads it, or with ``towers_only`` the CLIP towers of
    a CLIP or CLIPIQA one (with or without the ``clip_model.`` prefix) into
    ``tower.clip_model``, the token embedding left out as the JAX tools
    leave it out (``with_token_embedding=False``).  Returns the names of the
    tensors the state dict lacks: ``strict`` raises ``ValueError`` on any,
    as the JAX FID tool refuses such a file; otherwise they keep their
    values, as the JAX Dose-CLIP trainer converts what it finds."""
    if towers_only:
        target = tower.clip_model
        sd = _strip(state_dict, clip_prefix(state_dict))
        sd.pop(TOKEN_EMBEDDING, None)
    else:
        target, sd = tower, state_dict
    own = target.state_dict()
    missing = [k for k in own if k not in sd]
    if strict and missing:
        raise ValueError(f"{source} is missing {len(missing)} expected tensors, "
                         f"e.g. {missing[:3]}")
    picked = {k: torch.as_tensor(sd[k]).reshape(own[k].shape).to(own[k].dtype)
              for k in own if k in sd}
    target.load_state_dict(picked, strict=False)
    return missing
