"""IQA helpers (mirror of ``founddiff_tpu/utils/iqa.py``; reference
src/DACLIP.py:680-854): :func:`dist_to_mos`, :func:`random_crop` and
:func:`clip_preprocess`, on NHWC tensors of any device."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from founddiff_tpu_torch.utils.resize import resize

# reference src/DACLIP.py:30-31 (OPENAI_CLIP_MEAN/STD)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def dist_to_mos(dist_score: torch.Tensor) -> torch.Tensor:
    """[*, C] class distribution -> [*, 1] mean opinion score
    (src/DACLIP.py:715-729)."""
    weights = torch.arange(1, dist_score.shape[-1] + 1, dtype=dist_score.dtype,
                           device=dist_score.device)
    return (dist_score * weights).sum(dim=-1, keepdim=True)


def random_crop(inputs: Union[torch.Tensor, Sequence[torch.Tensor]], crop_size: int,
                crop_num: int, rng: np.random.RandomState = None):
    """``crop_num`` random crops shared across a list of NHWC images
    (src/DACLIP.py:732-761), each offset drawn from ``rng`` as JAX draws it
    (row, then column, per crop).  Images no larger than ``crop_size`` are
    upscaled bilinearly first.  Returns [B * crop_num, ch, cw, C] (a list
    for a list)."""
    single = not isinstance(inputs, (list, tuple))
    input_list: List[torch.Tensor] = [inputs] if single else list(inputs)
    rng = rng or np.random.RandomState()
    b, h, w, c = input_list[0].shape
    ch = cw = crop_size
    if min(h, w) <= crop_size:
        scale = (crop_size + 1) / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        input_list = [resize(x, (x.shape[0], nh, nw, x.shape[-1]), "bilinear")
                      for x in input_list]
        b, h, w, c = input_list[0].shape
    crops = [[] for _ in input_list]
    for _ in range(crop_num):
        sh = int(rng.randint(0, h - ch + 1))
        sw = int(rng.randint(0, w - cw + 1))
        for j, x in enumerate(input_list):
            crops[j].append(x[:, sh:sh + ch, sw:sw + cw, :])
    out = [torch.stack(cs, dim=1).reshape(b * crop_num, ch, cw, -1) for cs in crops]
    return out[0] if single else out


def clip_preprocess(x: torch.Tensor, input_resolution: int = 224) -> torch.Tensor:
    """CLIP preprocessing of [B, H, W, 3] float images in [0, 1]
    (``clip_preprocess_tensor``, src/DACLIP.py:764-780): truncated to bytes
    as the reference's ``.byte()`` does, the short side resized to
    ``input_resolution`` (bicubic, antialiased when it shrinks, as
    ``jax.image.resize``), center-cropped, normalized with the OpenAI mean
    and std."""
    x = torch.floor(x.clamp(0.0, 1.0) * 255.0)
    B, H, W, C = x.shape
    r = input_resolution
    if H < W:
        nh, nw = r, max(r, int(round(W * r / H)))
    else:
        nh, nw = max(r, int(round(H * r / W))), r
    x = resize(x, (B, nh, nw, C), "bicubic")
    top, left = (nh - r) // 2, (nw - r) // 2
    x = x[:, top:top + r, left:left + r, :] / 255.0
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
