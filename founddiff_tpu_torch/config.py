"""Config tree of the serving and training paths, FoundDiff and the vanilla
DDPM baseline (mirror of ``founddiff_tpu/config.py``).

Only the fields those paths read; defaults are the reference's shipped
values (train.py:39-119).
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
    # the vanilla lucidrains path: VanillaUnet + GaussianDiffusion
    # (train.py:59,85-95; set condition False with it, as train.py does)
    original_ddim_ddpm: bool = False


@dataclasses.dataclass
class DiffusionConfig:
    image_size: int = 512  # train.py:73
    timesteps: int = 1000  # train.py:109
    sampling_timesteps: int = 2  # train.py:39
    loss_type: str = "l2"  # train.py:112
    sum_scale: float = 0.01  # train.py:71
    ddim_sampling_eta: float = 0.0
    # 'use_pred_noise' (shipped) | 'use_x_start' (reference src/DADiff.py:1343-1349)
    ddim_update: str = "use_pred_noise"
    convert_to_ddim: bool = True
    clip_denoised: bool = True


@dataclasses.dataclass
class TrainConfig:
    train_num_steps: int = 200000  # train.py:41
    train_batch_size: int = 2  # train.py:43
    gradient_accumulate_every: int = 2  # train.py:139
    train_lr: float = 2e-4  # train.py:137
    adam_betas: Tuple[float, float] = (0.9, 0.99)  # src/DADiff.py:1596-1597
    max_grad_norm: float = 1.0  # src/DADiff.py:1707
    ema_decay: float = 0.995  # train.py:140
    ema_update_every: int = 10
    save_and_sample_every: int = 1000  # train.py:53
    num_samples: int = 1  # train.py:70
    seed: int = 10  # train.py:27
    mixed_precision: str = "no"  # 'no' | 'bf16' (reference runs fp32)
    checkpoint_folder: str = "checkpoints/FoundDiff"
    keep_checkpoints: int = 3  # older milestone files are pruned (0 = keep all)


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
    cfg.train.save_and_sample_every = 2
    cfg.diffusion.sampling_timesteps = 10
    cfg.train.train_num_steps = 200
    return cfg
