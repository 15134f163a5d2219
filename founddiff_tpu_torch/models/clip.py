"""Dose-CLIP tower (CLIPIQA over CLIP RN50) in PyTorch, frozen.

Mirror of ``founddiff_tpu/models/clip.py`` for the pieces the serving path
runs: the ModifiedResNet visual tower with its mean-token attention pool
(reference src/DACLIP.py:168-349), the QuickGELU text transformer over the
learned prompts (src/DACLIP.py:352-398, 895-969) and the CLIPIQA heads
(src/DACLIP.py:1135-1221).  Parameter names follow the reference state dict;
BatchNorms are eval-mode affines.  The tower runs in float32.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from founddiff_tpu_torch.models.blocks import Dense, conv


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last (channel) axis."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv + (self.bias - self.running_mean * inv)


def _avg_pool(x, k):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (src/DACLIP.py:168-211)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict(
                [("0", conv(inplanes, out, 1, bias=False)), ("1", FrozenBatchNorm(out))]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling of the mean token (src/DACLIP.py:214-259); the
    positional embedding is skipped (``pos_embedding=False`` at 512 px)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim)
        self.k_proj = Dense(embed_dim, embed_dim)
        self.v_proj = Dense(embed_dim, embed_dim)
        self.c_proj = Dense(embed_dim, output_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        hd = C // self.num_heads
        heads = lambda u: u.reshape(B, -1, self.num_heads, hd).transpose(1, 2)
        q = heads(self.q_proj(tokens[:, :1]))
        k = heads(self.k_proj(tokens))
        v = heads(self.v_proj(tokens))
        attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, C)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    """CLIP RN50 visual tower (src/DACLIP.py:262-349)."""

    def __init__(self, layers=(3, 4, 6, 3), output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64):
        super().__init__()
        w = width
        self.conv1 = conv(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(w // 2)
        self.conv2 = conv(w // 2, w // 2, 3, bias=False)
        self.bn2 = FrozenBatchNorm(w // 2)
        self.conv3 = conv(w // 2, w, 3, bias=False)
        self.bn3 = FrozenBatchNorm(w)
        inplanes = w
        for li, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers), start=1):
            stride = 1 if li == 1 else 2
            seq = [Bottleneck(inplanes, w * mult, stride)]
            inplanes = w * mult * Bottleneck.expansion
            seq += [Bottleneck(inplanes, w * mult) for _ in range(1, blocks)]
            setattr(self, f"layer{li}", nn.Sequential(*seq))
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads, output_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        if H < 32 or W < 32:
            # micro towers: the 32x reduction would leave no grid (clip.py:170-177)
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(max(H, 32), max(W, 32)),
                              mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = _avg_pool(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _MHAWeights(nn.Module):
    """``nn.MultiheadAttention``'s parameter names (in_proj_*, out_proj)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model)


class ResidualAttentionBlock(nn.Module):
    """Transformer block with QuickGELU (src/DACLIP.py:364-387)."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.ln_1 = nn.LayerNorm(d_model)
        self.attn = _MHAWeights(d_model)
        self.ln_2 = nn.LayerNorm(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", Dense(d_model, 4 * d_model)), ("gelu", QuickGELU()),
            ("c_proj", Dense(4 * d_model, d_model))]))

    def forward(self, x, attn_mask=None):
        B, L, C = x.shape
        y = self.ln_1(x)
        q, k, v = F.linear(y, self.attn.in_proj_weight, self.attn.in_proj_bias).chunk(3, dim=-1)
        hd = C // self.n_head
        heads = lambda u: u.reshape(B, L, self.n_head, hd).transpose(1, 2)
        q, k, v = map(heads, (q, k, v))
        sim = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if attn_mask is not None:
            sim = sim + attn_mask
        out = (torch.softmax(sim, dim=-1) @ v).transpose(1, 2).reshape(B, L, C)
        x = x + self.attn.out_proj(out)
        return x + self.mlp(self.ln_2(x))


class TextTransformer(nn.Module):
    """Causal text transformer (src/DACLIP.py:390-398)."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads)
                                         for _ in range(layers)])

    def forward(self, x):
        L = x.shape[1]
        mask = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class CLIP(nn.Module):
    """CLIP with the RN visual tower (src/DACLIP.py:450-581); the token
    embedding and ``encode_text`` are not part of the serving path."""

    def __init__(self, embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
                 vision_width=64, context_length=77, transformer_width=512,
                 transformer_heads=8, transformer_layers=12):
        super().__init__()
        self.visual = ModifiedResNet(tuple(vision_layers), embed_dim,
                                     vision_width * 32 // 64, image_resolution, vision_width)
        self.transformer = TextTransformer(transformer_width, transformer_layers,
                                           transformer_heads)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, transformer_width))
        self.ln_final = nn.LayerNorm(transformer_width)
        self.text_projection = nn.Parameter(torch.empty(transformer_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, image):
        return self.visual(image)

    def encode_prompt_embedding(self, prompt_embeds, eot_indices):
        """Already-embedded prompts through the text tower (src/DACLIP.py:956-969)."""
        x = prompt_embeds + self.positional_embedding[None]
        x = self.ln_final(self.transformer(x))
        x = x[torch.arange(x.shape[0], device=x.device), eot_indices]
        return x @ self.text_projection


class PromptLearner(nn.Module):
    """Learned context around the fixed CT prompts (src/DACLIP.py:895-969);
    ``token_prefix``/``token_suffix`` are the frozen prompt embeddings."""

    def __init__(self, n_cls=2, n_ctx=16, width=512, context_length=77,
                 name_lens=(3, 3), eot_indices=(24, 25)):
        super().__init__()
        self.n_cls, self.n_ctx = n_cls, n_ctx
        self.name_lens = tuple(name_lens)
        self.eot_indices = tuple(eot_indices)
        self.ctx = nn.Parameter(torch.empty(n_cls, n_ctx, width))
        self.register_buffer("token_prefix", torch.zeros(n_cls, 1, width))
        self.register_buffer("token_suffix",
                             torch.zeros(n_cls, context_length - 1 - n_ctx, width))

    def forward(self, clip_model: CLIP):
        half = self.n_ctx // 2
        prompts = []
        for i in range(self.n_cls):
            nl = self.name_lens[i]
            prompts.append(torch.cat([
                self.token_prefix[i:i + 1], self.ctx[i:i + 1, :half],
                self.token_suffix[i:i + 1, :nl], self.ctx[i:i + 1, half:],
                self.token_suffix[i:i + 1, nl:]], dim=1))
        eot = torch.tensor(self.eot_indices, device=self.ctx.device)
        return clip_model.encode_prompt_embedding(torch.cat(prompts, dim=0), eot)


class CLIPIQA(nn.Module):
    """Dose-CLIP encoder (src/DACLIP.py:1135-1221).  ``forward`` returns
    (dose_prob [B,1], dose_embedding [B,embed], content_embedding [B,256])."""

    def __init__(self, backbone_resolution: int = 224, embed_dim: int = 1024,
                 vision_layers: Tuple[int, ...] = (3, 4, 6, 3), vision_width: int = 64,
                 transformer_width: int = 512, transformer_layers: int = 12,
                 transformer_heads: int = 8,
                 prompt_eot_indices: Tuple[int, ...] = (24, 25),
                 prompt_name_lens: Tuple[int, ...] = (3, 3)):
        super().__init__()
        self.embed_dim = embed_dim
        self.clip_model = CLIP(embed_dim, backbone_resolution, vision_layers, vision_width,
                               transformer_width=transformer_width,
                               transformer_heads=transformer_heads,
                               transformer_layers=transformer_layers)
        self.prompt_learner = PromptLearner(width=transformer_width,
                                            name_lens=prompt_name_lens,
                                            eot_indices=prompt_eot_indices)
        self.head1 = nn.Sequential(Dense(embed_dim, 1024), nn.ReLU(), Dense(1024, embed_dim))
        self.head2 = nn.Sequential(Dense(embed_dim, 1024), nn.ReLU(), Dense(1024, 256))

    def embed(self, x):
        """(dose_embedding, content_embedding), both L2-normalized; x [B,H,W,3]
        in the model's [-1, 1] domain (no CLIP mean/std normalization)."""
        features = self.clip_model.encode_image(x)
        image_features = self.head1(features)
        content = self.head2(features)
        image_features = image_features / image_features.norm(dim=-1, keepdim=True)
        content = content / content.norm(dim=-1, keepdim=True)
        return image_features, content

    def forward(self, x):
        image_features, content = self.embed(x)
        text = self.prompt_learner(self.clip_model)
        text = text / text.norm(dim=-1, keepdim=True)
        logits = math.exp(math.log(1 / 0.07)) * image_features @ text.t()
        probs = torch.softmax(logits.reshape(x.shape[0], -1, 2), dim=-1)
        return probs[..., 0].mean(dim=1, keepdim=True), image_features, content
