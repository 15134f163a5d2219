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
from founddiff_tpu_torch.ops.flash_attention import flash_attention
from founddiff_tpu_torch.ops.groupnorm import group_norm_silu
from founddiff_tpu_torch.ops.norm import layer_norm


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


class LNorm(nn.LayerNorm):
    """LayerNorm over the last axis through :func:`layer_norm`, the kernel
    of ``_ln_kernel`` (blocks.py:200-220); the parameters and their names are
    ``nn.LayerNorm``'s."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


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


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """``[t, sin(2 pi t w), cos(2 pi t w)]`` with w [dim // 2] from N(0, 1)
    (src/DADiff.py:189-205, crowsonkb's random Fourier features): learned,
    or with ``is_random`` fixed (no gradient reaches w, as the JAX
    ``stop_gradient``).  Output width ``2 * (dim // 2) + 1``."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        self.is_random = is_random
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not is_random)

    def forward(self, t):
        w = self.weights.detach() if self.is_random else self.weights
        t = t.float()[:, None]
        freqs = t * w.float()[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimestepEmbedder(nn.Module):
    """DiT timestep embedder (src/DADiff.py:490-527): the cos-first
    frequency embedding (a zero column at odd ``frequency_embedding_size``),
    then ``mlp`` = Linear, SiLU, Linear (keys ``mlp.0``, ``mlp.2``)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(Dense(frequency_embedding_size, hidden_size), nn.SiLU(),
                                 Dense(hidden_size, hidden_size))

    @staticmethod
    def timestep_embedding(t, dim: int, max_period: int = 10000):
        half = dim // 2
        freqs = torch.exp(-math.log(max_period)
                          * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        if dim % 2:
            emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
        return emb

    def forward(self, t):
        return self.mlp(self.timestep_embedding(t, self.frequency_embedding_size))


class Block(nn.Module):
    """WSConv -> GroupNorm -> (scale/shift) -> SiLU (+ residual)
    (src/DADiff.py:214-233); the GroupNorm epilogue is
    :func:`~founddiff_tpu_torch.ops.groupnorm.group_norm_silu`, whose route
    (plain or the two kernels) follows ``FOUNDDIFF_GN``."""

    def __init__(self, c_in, c_out, groups=8):
        super().__init__()
        self.groups = groups
        self.proj = WSConv(c_in, c_out)
        self.norm = nn.GroupNorm(groups, c_out)

    def forward(self, x, residual=None, skip=None, scale_shift=None):
        y = self.proj(x, skip)
        return group_norm_silu(y, self.norm.weight, self.norm.bias, residual=residual,
                               scale_shift=scale_shift, groups=self.groups, eps=1e-5)


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


class ChanLayerNorm(nn.Module):
    """Channel LayerNorm with biased variance and a scale only (the
    lucidrains ``LayerNorm``; JAX ``ChanLayerNorm`` blocks.py:223-235): eps
    1e-5 in fp32 and 1e-3 otherwise, statistics in fp32.  ``g`` keeps the
    reference shape [1, C, 1, 1]."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + eps) * self.g.reshape(-1).float()).to(x.dtype)


class PreNorm(nn.Module):
    """``fn(ChanLayerNorm(x))`` (lucidrains ``PreNorm``; keys ``fn.*``, ``norm.g``)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChanLayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """``fn(x) + x`` (lucidrains ``Residual``; keys ``fn.*``)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def _heads(u, heads: int):
    """[B, H, W, heads * d] -> [B, heads, H * W, d]."""
    B, H, W, _ = u.shape
    return u.reshape(B, H * W, heads, -1).transpose(1, 2)


class LinearAttention(nn.Module):
    """Linear attention (src/DADiff.py:287-317; JAX blocks.py:506-533): q
    softmaxed over the head dim and k over the pixels, v / (H * W), then
    ``to_out`` (a 1x1 conv and a ChanLayerNorm)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = conv(dim, 3 * hidden, 1, bias=False)
        self.to_out = nn.Sequential(conv(hidden, dim, 1), ChanLayerNorm(dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = (_heads(u, self.heads).transpose(-1, -2)  # [B, heads, d, L]
                   for u in self.to_qkv(x).chunk(3, dim=-1))
        q = torch.softmax(q, dim=-2) * self.dim_head ** -0.5
        k = torch.softmax(k, dim=-1)
        v = v / (H * W)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.permute(0, 3, 1, 2).reshape(B, H, W, -1))


class Attention(nn.Module):
    """Full softmax self-attention (src/DADiff.py:369-392; JAX
    blocks.py:536-578).  ``use_flash=None`` routes H * W >= 1024 to
    :func:`flash_attention` and shorter sequences to the plain product,
    which casts the probabilities to v's dtype before the second product."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, use_flash=None):
        super().__init__()
        self.heads, self.dim_head, self.use_flash = heads, dim_head, use_flash
        hidden = heads * dim_head
        self.to_qkv = conv(dim, 3 * hidden, 1, bias=False)
        self.to_out = conv(hidden, dim, 1)

    def forward(self, x):
        B, H, W, _ = x.shape
        scale = self.dim_head ** -0.5
        q, k, v = (_heads(u, self.heads) for u in self.to_qkv(x).chunk(3, dim=-1))
        use_flash = self.use_flash if self.use_flash is not None else H * W >= 1024
        if use_flash:
            out = flash_attention(q, k, v, scale)
        else:
            sim = (q * scale).float() @ k.float().transpose(-1, -2)
            out = torch.softmax(sim, dim=-1).to(v.dtype) @ v
        return self.to_out(out.transpose(1, 2).reshape(B, H, W, -1))


class ChannelAttention(nn.Module):
    """RCAN squeeze-excite channel attention (src/DADiff.py:232-249): the
    pixel mean, a 1x1 conv to ``num_feat // squeeze_factor``, ReLU, a 1x1
    conv back, and ``x * sigmoid(.)`` (keys ``attention.1``, ``attention.3``)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                       conv(num_feat, num_feat // squeeze_factor, 1),
                                       nn.ReLU(), conv(num_feat // squeeze_factor, num_feat, 1),
                                       nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(1, 2), keepdim=True)
        y = self.attention[3](torch.relu(self.attention[1](y)))
        return x * torch.sigmoid(y)


class CrossAttention(nn.Module):
    """Pixel-to-context attention (src/DADiff.py:319-366; JAX
    blocks.py:581-615): x [B, H, W, query_dim] attends to ``context`` [B,
    Lk, context_dim], or to itself without one.  Where ``Lq * Lk >= 1024^2``
    and ``Lk >= 128`` the product runs through :func:`flash_attention`
    (its kernels on the card), else as the plain softmax, the probabilities
    cast to v's dtype.  ``to_out`` = Linear, Dropout (keys ``to_out.0``);
    the dropout acts in train mode only."""

    def __init__(self, query_dim: int, context_dim: int = 256, heads: int = 4,
                 dim_head: int = 32, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(query_dim, inner, bias=False)
        self.to_k = Dense(context_dim, inner, bias=False)
        self.to_v = Dense(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Dense(inner, query_dim), nn.Dropout(dropout))

    def forward(self, x, context=None):
        B, H, W, C = x.shape
        xf = x.reshape(B, H * W, C)
        ctx = xf if context is None else context
        heads = lambda u: u.reshape(B, u.shape[1], self.heads, -1).transpose(1, 2)
        q, k, v = heads(self.to_q(xf)), heads(self.to_k(ctx)), heads(self.to_v(ctx))
        scale = self.dim_head ** -0.5
        Lq, Lk = q.shape[2], k.shape[2]
        if Lq * Lk >= 1024 * 1024 and Lk >= 128:
            out = flash_attention(q, k, v, scale)
        else:
            sim = (q.float() @ k.float().transpose(-1, -2)) * scale
            out = torch.softmax(sim, dim=-1).to(v.dtype) @ v
        out = self.to_out(out.transpose(1, 2).reshape(B, H * W, -1))
        return out.reshape(B, H, W, -1)


def modulate(x, shift, scale):
    """adaLN modulation of NHWC maps (src/DADiff.py:450-451)."""
    return x * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
