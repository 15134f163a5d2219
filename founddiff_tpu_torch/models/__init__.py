"""The port's models (``founddiff_tpu/models/__init__.py``)."""

from founddiff_tpu_torch.models.blocks import (
    Attention,
    Block,
    ChanLayerNorm,
    ChannelAttention,
    CrossAttention,
    Downsample,
    LinearAttention,
    RandomOrLearnedSinusoidalPosEmb,
    ResnetBlock,
    SinusoidalPosEmb,
    TimestepEmbedder,
    TransposedAttention,
    Upsample,
    WSConv,
)
from founddiff_tpu_torch.models.ss2d import SS2D, MambaBlock, PatchMerging2D
from founddiff_tpu_torch.models.unet import Unet, UnetRes
from founddiff_tpu_torch.models.vanilla_unet import TimeResnetBlock, VanillaUnet
from founddiff_tpu_torch.models.clip import CLIP, CLIPIQA, PromptLearner
from founddiff_tpu_torch.models.lpips import LPIPS
from founddiff_tpu_torch.models.founddiff import FoundDiffDenoiser

__all__ = [
    "Attention",
    "Block",
    "CLIP",
    "CLIPIQA",
    "ChanLayerNorm",
    "ChannelAttention",
    "CrossAttention",
    "Downsample",
    "FoundDiffDenoiser",
    "LPIPS",
    "LinearAttention",
    "MambaBlock",
    "PatchMerging2D",
    "PromptLearner",
    "RandomOrLearnedSinusoidalPosEmb",
    "ResnetBlock",
    "SS2D",
    "SinusoidalPosEmb",
    "TimeResnetBlock",
    "TimestepEmbedder",
    "TransposedAttention",
    "Unet",
    "UnetRes",
    "Upsample",
    "VanillaUnet",
    "WSConv",
]
