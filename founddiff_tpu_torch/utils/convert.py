"""JAX-package parameters -> this package's ``state_dict``.

``from_jax_params`` takes the param tree of the JAX package's
``FoundDiffDenoiser`` (``{"dose_encoder": ..., "model": {"unet0": ...}}``),
``UnetRes`` (``{"unet0": ...}``) or ``VanillaUnet`` (``{"init_conv": ...,
"mid_block1": ...}``) as nested dicts of arrays and returns tensors under the
port's names.  Those are the reference PyTorch state-dict names: for
FoundDiff the inverse of ``founddiff_tpu/utils/torch_convert.py:135-475``;
for the vanilla UNet the lucidrains ``Unet``'s (``downs.<i>.<0..3>``,
``mid_attn.fn.fn``, ``mlp.1``, ...), which the JAX package has no converter
for and no reference checkpoint has been loaded against.

Layout changes: Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
conv ``kernel [kh, kw, I/g, O]`` -> ``weight [O, I/g, kh, kw]`` (depthwise
``[3, 3, 1, D]`` -> ``[D, 1, 3, 3]``); norm ``scale`` -> ``weight``;
BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``;
``A_logs [K, D, N]`` -> ``[K*D, N]``; ``Ds [K, D]`` -> ``[K*D]``;
ChanLayerNorm ``g [C]`` -> ``[1, C, 1, 1]``.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAMES = [(re.compile(p), r) for p, r in [
    (r"^down_(\d+)_attn$", r"downs.\1.1"), (r"^down_(\d+)_res$", r"downs.\1.0"),
    (r"^down_(\d+)_down$", r"downs.\1.2"), (r"^up_(\d+)_res$", r"ups.\1.0"),
    (r"^up_(\d+)_attn$", r"ups.\1.1"), (r"^up_(\d+)_up$", r"ups.\1.2"),
    (r"^time_mlp_1$", "time_mlp.1"), (r"^time_mlp_2$", "time_mlp.3"),
    (r"^text_mlp_1$", "text_mlp.0"), (r"^text_mlp_2$", "text_mlp.2"),
    (r"^adaLN$", "adaLN_modulation.1"), (r"^dwconv$", "conv2d"),
    (r"^cond_proj$", "attn.0"), (r"^layer(\d)_(\d+)$", r"layer\1.\2"),
    (r"^downsample_conv$", "downsample.0"), (r"^downsample_bn$", "downsample.1"),
    (r"^resblock_(\d+)$", r"resblocks.\1"), (r"^attn_out_proj$", "attn.out_proj"),
    (r"^mlp_c_fc$", "mlp.c_fc"), (r"^mlp_c_proj$", "mlp.c_proj"),
    (r"^head(\d)_fc1$", r"head\1.0"), (r"^head(\d)_fc2$", r"head\1.2"),
]]
# the vanilla UNet's modules (JAX vanilla_unet.py:56-141 -> lucidrains Unet)
_VANILLA_RENAMES = [(re.compile(p), r) for p, r in [
    (r"^(down|up)_(\d+)_block1$", r"\1s.\2.0"), (r"^(down|up)_(\d+)_block2$", r"\1s.\2.1"),
    (r"^(down|up)_(\d+)_attn$", r"\1s.\2.2.fn.fn"),
    (r"^(down|up)_(\d+)_attn_norm$", r"\1s.\2.2.fn.norm"),
    (r"^down_(\d+)_down$", r"downs.\1.3"), (r"^up_(\d+)_up$", r"ups.\1.3"),
    (r"^mid_attn$", "mid_attn.fn.fn"), (r"^mid_attn_norm$", "mid_attn.fn.norm"),
    (r"^time_mlp_1$", "time_mlp.1"), (r"^time_mlp_2$", "time_mlp.3"), (r"^mlp$", "mlp.1"),
    (r"^to_out_norm$", "to_out.1"),
]]
_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(parts, renames) -> str:
    out = []
    for p in parts:
        if p == "conv" and out and out[-1].startswith(("downs.", "ups.")):
            # Downsample is a bare conv; Upsample = Sequential(nearest, conv)
            if out[-1].startswith("ups."):
                out.append("1")
            continue
        if p == "attn_in_proj":
            out.append("attn.in_proj")
            continue
        if p == "to_out" and out and re.match(r"^(downs|ups)\.\d+\.2\.fn\.fn$", out[-1]):
            out.append("to_out.0")  # LinearAttention's to_out = Sequential(conv, norm)
            continue
        for pat, rep in renames:
            if pat.match(p):
                p = pat.sub(rep, p)
                break
        out.append(p)
    return ".".join(out)


def _torch_key(path: Tuple[str, ...], renames) -> str:
    if path[0] == "dose_encoder":
        prefix, path = "unet0.dose_encoder.", path[1:]
    else:
        prefix = ""
        if path[0] == "model":
            path = path[1:]
    mod, leaf = _module_name(path[:-1], renames), path[-1]
    if mod.endswith("attn.in_proj"):
        return prefix + mod + {"kernel": "_weight", "bias": "_bias"}[leaf]
    return prefix + (f"{mod}." if mod else "") + _LEAVES.get(leaf, leaf)


def _value(path: Tuple[str, ...], arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    leaf = path[-1]
    if leaf == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    elif leaf == "A_logs":
        a = a.reshape(-1, a.shape[-1])
    elif leaf == "Ds":
        a = a.reshape(-1)
    elif leaf == "g":
        a = a.reshape(1, -1, 1, 1)
    return torch.tensor(np.ascontiguousarray(a))


def from_jax_params(params: Mapping, vanilla: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """The JAX param tree as this package's ``state_dict``.  ``vanilla``
    names the family; by default a tree with ``mid_block1`` is a VanillaUnet."""
    if vanilla is None:
        vanilla = "mid_block1" in params
    renames = _VANILLA_RENAMES if vanilla else _RENAMES
    return {_torch_key(p, renames): _value(p, v) for p, v in _leaves(params)}


def _uncalled_unet(model) -> Optional[str]:
    """The state-dict prefix of the UNet that a two-UNet model never calls
    (``test_res_or_noise`` "res" or "noise"), else None."""
    if getattr(model, "num_unet", 1) != 2:
        return None
    return {"res": "unet1.", "noise": "unet0."}.get(getattr(model, "test_res_or_noise", None))


def load_jax_params(model: torch.nn.Module, params: Mapping,
                    vanilla: Optional[bool] = None) -> torch.nn.Module:
    """Load a JAX param tree into ``model`` (``from_jax_params``), strictly.

    One exception: flax creates a submodule's parameters at its first call,
    so a JAX ``UnetRes`` with ``num_unet=2`` and ``test_res_or_noise`` "res"
    or "noise" holds only the UNet it calls (``models/unet.py:263-270``).
    The port builds both; when the tree lacks every parameter of the UNet
    that is never called (the tower under ``unet0.dose_encoder`` aside), that
    UNet keeps its init and a warning names its prefix.  Any other missing
    or unexpected key raises.  Returns ``model``."""
    sd = from_jax_params(params, vanilla)
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    unexpected = [k for k in sd if k not in own]
    prefix = _uncalled_unet(model)
    if prefix is not None and missing:
        tower = prefix + "dose_encoder."
        under = [k for k in own if k.startswith(prefix) and not k.startswith(tower)]
        if under and all(k not in sd for k in under):
            warnings.warn(f"load_jax_params: the tree has no {prefix}* parameters (the UNet "
                          f"test_res_or_noise={model.test_res_or_noise!r} never calls); "
                          f"{prefix}* keeps its init", stacklevel=2)
            missing = [k for k in missing if k not in set(under)]
    if missing or unexpected:
        raise RuntimeError(f"load_jax_params: missing keys {missing[:8]} ({len(missing)}), "
                           f"unexpected keys {unexpected[:8]} ({len(unexpected)})")
    model.load_state_dict(sd, strict=False)
    return model
