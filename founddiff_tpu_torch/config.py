"""Config tree of the serving path (mirror of ``founddiff_tpu/config.py``).

Only the fields the hoisted DDIM path reads; defaults are the reference's
shipped values (train.py:39-119).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class ModelConfig:
    dim: int = 64
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 1
    num_unet: int = 1
    objective: str = "pred_res"  # train.py:81
    test_res_or_noise: str = "res"  # train.py:82
    condition: bool = True
    input_condition: bool = False
    self_condition: bool = False
    resnet_block_groups: int = 8
    base_d_state: int = 4
    ssm_expand: float = 2.0
    clip_backbone: str = "RN50"


@dataclasses.dataclass
class DiffusionConfig:
    image_size: int = 512  # train.py:73
    timesteps: int = 1000  # train.py:109
    sampling_timesteps: int = 2  # train.py:39
    sum_scale: float = 0.01  # train.py:71
    ddim_sampling_eta: float = 0.0
    # 'use_pred_noise' (shipped) | 'use_x_start' (reference src/DADiff.py:1343-1349)
    ddim_update: str = "use_pred_noise"
    convert_to_ddim: bool = True
    clip_denoised: bool = True


@dataclasses.dataclass
class TrainConfig:
    seed: int = 10  # train.py:27


@dataclasses.dataclass
class Config:
    name: str = "FoundDiff"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def debug_config() -> Config:
    """Tiny-cadence config analogous to the reference's ``debug=True`` branch
    (train.py:48-57)."""
    cfg = Config()
    cfg.diffusion.sampling_timesteps = 10
    return cfg
