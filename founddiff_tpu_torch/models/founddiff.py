"""FoundDiff composed denoiser: frozen Dose-CLIP tower + UnetRes
(mirror of ``founddiff_tpu/models/founddiff.py``).

``encode`` runs the tower alone so the sampler can hoist the dose/content
embeddings out of the DDIM loop; ``forward`` recomputes them from the
conditioning channel when none are given, as the reference does on every
call (src/DADiff.py:685-709).
"""

from __future__ import annotations

import torch

from founddiff_tpu_torch.models.clip import CLIPIQA
from founddiff_tpu_torch.models.unet import UnetRes


class FoundDiffDenoiser(UnetRes):
    """UnetRes whose ``unet0`` holds the CLIPIQA tower at ``unet0.dose_encoder``
    (the reference key layout).  ``clip_overrides`` shrink the tower for tests."""

    def __init__(self, dim: int, dim_mults=(1, 2, 4, 8), channels: int = 1,
                 num_unet: int = 1, condition: bool = True, input_condition: bool = False,
                 self_condition: bool = False, resnet_block_groups: int = 8,
                 objective: str = "pred_res", test_res_or_noise: str = "res",
                 base_d_state: int = 4, ssm_expand: float = 2.0,
                 clip_backbone: str = "RN50", clip_overrides=()):
        if clip_backbone != "RN50":
            raise ValueError("the reference ships the RN50 tower only")
        tower = CLIPIQA(**dict(clip_overrides))
        super().__init__(dim, dim_mults, channels, self_condition, resnet_block_groups,
                         num_unet, condition, input_condition, objective,
                         test_res_or_noise, base_d_state, ssm_expand,
                         context_dim=tower.embed_dim, dose_encoder=tower)
        self.channels = channels
        self.condition = condition

    @property
    def dose_encoder(self) -> CLIPIQA:
        return self.unet0.dose_encoder

    @torch.no_grad()
    def encode(self, x_input):
        """(dose [B, embed], content [B, 1, 256]) from the conditioning image
        x_input [B,H,W,channels] in [-1, 1], tripled to RGB (src/DADiff.py:692).
        The tower computes in x_input's dtype: float32 when serving, bf16 in
        a bf16 train step, as the JAX step runs it."""
        rgb = x_input[..., :self.channels].repeat_interleave(3, dim=-1)
        dose, content = self.dose_encoder.embed(rgb)
        return dose, content[:, None, :]

    def forward(self, x, time, x_self_cond=None, dose_embedding=None,
                content_embedding=None):
        if self.condition and dose_embedding is None:
            cond = x[..., self.channels:2 * self.channels]
            dose_embedding, content_embedding = self.encode(cond)
        return super().forward(x, time, x_self_cond=x_self_cond,
                               dose_embedding=dose_embedding,
                               content_embedding=content_embedding)
