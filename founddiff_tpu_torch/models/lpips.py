"""LPIPS perceptual distance with the AlexNet backbone (mirror of
``founddiff_tpu/models/lpips.py``).

The reference builds a frozen ``lpips.LPIPS(net='alex')`` for its optional
perceptual loss term (src/DADiff.py:1029-1031).  The five AlexNet conv
stages, unit-normalized feature differences, 1x1 linear heads, the spatial
mean, summed over the stages; images NHWC in [-1, 1].  The names are the
torch ``lpips`` package's (``scaling_layer.shift``/``scale``,
``net.slice<k>.<torchvision index>``, ``lin<i>.model.1``), so such a state
dict loads as it is: the inverse of the JAX ``convert_lpips``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from founddiff_tpu_torch.models.blocks import conv

# the ImageNet scaling LPIPS applies to its [-1, 1] input
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class _ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift.reshape(3).to(x.dtype)) / self.scale.reshape(3).to(x.dtype)


def _max_pool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


class _Pool(nn.Module):
    def forward(self, x):
        return _max_pool(x)


class AlexNetFeatures(nn.Module):
    """The AlexNet feature stack (torchvision indices 0-11) in LPIPS's five
    slices; ``forward`` returns the five relu outputs LPIPS taps."""

    LAYERS = ((1, "0", (3, 64, 11, 4, 2)), (2, "3", (64, 192, 5, 1, 2)),
              (3, "6", (192, 384, 3, 1, 1)), (4, "8", (384, 256, 3, 1, 1)),
              (5, "10", (256, 256, 3, 1, 1)))

    def __init__(self):
        super().__init__()
        for k, idx, (ci, co, ksz, stride, pad) in self.LAYERS:
            mods = []
            if k in (2, 3):  # the max pool before the conv, at the index below it
                mods.append((str(int(idx) - 1), _Pool()))
            mods += [(idx, conv(ci, co, ksz, stride=stride, padding=pad)),
                     (str(int(idx) + 1), nn.ReLU())]
            setattr(self, f"slice{k}", nn.Sequential(OrderedDict(mods)))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for k in range(1, 6):
            x = getattr(self, f"slice{k}")(x)
            feats.append(x)
        return tuple(feats)


class _NetLin(nn.Module):
    """``lpips.NetLinLayer``: Sequential(Dropout, 1x1 conv without bias)."""

    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), conv(c, 1, 1, bias=False))

    def forward(self, x):
        return self.model[1](x)  # the dropout is off in eval, as the reference runs it


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=-1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance ``[B]`` between two NHWC RGB images in [-1, 1]."""

    CHANNELS = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.scaling_layer = _ScalingLayer()
        self.net = AlexNetFeatures()
        for i, c in enumerate(self.CHANNELS):
            setattr(self, f"lin{i}", _NetLin(c))

    def forward(self, x0, x1):
        f0 = self.net(self.scaling_layer(x0))
        f1 = self.net(self.scaling_layer(x1))
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + getattr(self, f"lin{i}")(d).mean(dim=(1, 2, 3))
        return total
