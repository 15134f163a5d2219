"""JAX-package parameters -> this package's ``state_dict``.

``from_jax_params`` takes the param tree of the JAX package's
``FoundDiffDenoiser`` (``{"dose_encoder": ..., "model": {"unet0": ...}}``)
or ``UnetRes`` (``{"unet0": ...}``) as nested dicts of arrays and returns
tensors under the port's names, which are the reference PyTorch state-dict
names (the inverse of ``founddiff_tpu/utils/torch_convert.py:135-475``).

Layout changes: Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``;
conv ``kernel [kh, kw, I/g, O]`` -> ``weight [O, I/g, kh, kw]`` (depthwise
``[3, 3, 1, D]`` -> ``[D, 1, 3, 3]``); norm ``scale`` -> ``weight``;
BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``;
``A_logs [K, D, N]`` -> ``[K*D, N]``; ``Ds [K, D]`` -> ``[K*D]``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

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
_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(parts) -> str:
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
        for pat, rep in _RENAMES:
            if pat.match(p):
                p = pat.sub(rep, p)
                break
        out.append(p)
    return ".".join(out)


def _torch_key(path: Tuple[str, ...]) -> str:
    if path[0] == "dose_encoder":
        prefix, path = "unet0.dose_encoder.", path[1:]
    else:
        prefix = ""
        if path[0] == "model":
            path = path[1:]
    mod, leaf = _module_name(path[:-1]), path[-1]
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
    return torch.tensor(np.ascontiguousarray(a))


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX param tree as this package's ``state_dict``."""
    return {_torch_key(p): _value(p, v) for p, v in _leaves(params)}
