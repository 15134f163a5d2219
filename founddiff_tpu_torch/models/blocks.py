"""UNet building blocks in PyTorch (mirror of ``founddiff_tpu/models/blocks.py``).

Activations are NHWC tensors.  Convolutions run on the NCHW view
``x.permute(0, 3, 1, 2)`` (channels-last in memory) and return an NHWC view.
Parameters keep the reference layout and names (Linear ``weight [out, in]``,
Conv2d ``weight [O, I/g, kh, kw]``), so a reference state dict loads as it
is.  Weights are float32 at rest and cast to the activation dtype at use, as
the JAX package casts its params (``kernel.astype(x.dtype)``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from founddiff_tpu_torch.ops.attn_block import transposed_attention


def conv_nhwc(x, weight, bias=None, stride=1, padding=0, groups=1):
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on NHWC input.  ``skip``: a second input whose channels
    follow ``x``'s — the same result as convolving ``cat([x, skip], -1)``,
    computed as two convs on the split kernel (blocks.py:83-157)."""

    def forward(self, x, skip=None):
        c1 = x.shape[-1]
        kw = dict(stride=self.stride, padding=self.padding, groups=self.groups)
        if skip is None:
            return conv_nhwc(x, self.weight, self.bias, **kw)
        y = conv_nhwc(x, self.weight[:, :c1], None, **kw)
        y = y + conv_nhwc(skip, self.weight[:, c1:], None, **kw)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def conv(c_in, c_out, k, stride=1, padding=None, groups=1, bias=True):
    return Conv(c_in, c_out, k, stride=stride,
                padding=k // 2 if padding is None else padding,
                groups=groups, bias=bias)


class WSConv(nn.Conv2d):
    """Weight-standardized 3x3 conv (reference src/DADiff.py:139-154): the
    kernel is standardized per output channel over (in, kh, kw) with biased
    variance and eps 1e-5 in fp32 / 1e-3 otherwise; ``skip`` as in
    :class:`Conv` (standardized jointly, then split)."""

    def __init__(self, c_in, c_out, k=3):
        super().__init__(c_in, c_out, k, padding=k // 2)

    def forward(self, x, skip=None):
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (w - mean) * torch.rsqrt(var + eps)
        c1 = x.shape[-1]
        y = conv_nhwc(x, w[:, :c1], padding=self.padding)
        if skip is not None:
            y = y + conv_nhwc(skip, w[:, c1:], padding=self.padding)
        return y + self.bias.to(y.dtype)


def group_norm_silu(x, scale, bias, residual=None, groups: int = 8, eps: float = 1e-5):
    """``silu(GroupNorm(x) * scale + bias) (+ residual)`` in fp32, cast back
    (``_gn_silu_xla``, groupnorm_pallas.py:150-166; the JAX default route)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * scale.float() + bias.float()
    y = F.silu(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


class SinusoidalPosEmb(nn.Module):
    """reference src/DADiff.py:173-185 (sin first)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        scale = math.log(10000) / (half - 1)
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -scale)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Block(nn.Module):
    """WSConv -> GroupNorm -> SiLU (+ residual) (src/DADiff.py:214-233)."""

    def __init__(self, c_in, c_out, groups=8):
        super().__init__()
        self.groups = groups
        self.proj = WSConv(c_in, c_out)
        self.norm = nn.GroupNorm(groups, c_out)

    def forward(self, x, residual=None, skip=None):
        y = self.proj(x, skip)
        return group_norm_silu(y, self.norm.weight, self.norm.bias, residual,
                               self.groups, 1e-5)


class ResnetBlock(nn.Module):
    """Single-block residual unit (src/DADiff.py:398-427).  ``c_in`` counts
    the skip channels a decoder block receives."""

    def __init__(self, c_in, c_out, groups=8):
        super().__init__()
        self.block1 = Block(c_in, c_out, groups)
        self.res_conv = conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, skip=None):
        res = x if self.res_conv is None else self.res_conv(x, skip)
        return self.block1(x, residual=res, skip=skip)


class _Nearest2x(nn.Module):
    def forward(self, x):
        B, H, W, C = x.shape
        return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


class Upsample(nn.Sequential):
    """nearest x2 + 3x3 conv (src/DADiff.py:129-133); keys ``1.weight``."""

    def __init__(self, c_in, c_out):
        super().__init__(_Nearest2x(), conv(c_in, c_out, 3))


def Downsample(c_in, c_out):
    """4x4 stride-2 conv (src/DADiff.py:136)."""
    return conv(c_in, c_out, 4, stride=2, padding=1)


class TransposedAttention(nn.Module):
    """Channel attention (src/DADiff.py:252-285): reference parameters, no
    bias.  ``forward`` takes the already-modulated input."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(3 * dim, 3 * dim, 3, padding=1, groups=3 * dim,
                                    bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def weights(self):
        return (self.qkv.weight, self.qkv_dwconv.weight, self.temperature,
                self.project_out.weight)

    def forward(self, x2):
        return transposed_attention(x2, *self.weights(), self.heads)


def modulate(x, shift, scale):
    """adaLN modulation of NHWC maps (src/DADiff.py:450-451)."""
    return x * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
