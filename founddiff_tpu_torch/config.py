"""Config tree of the serving, training and evaluation paths, FoundDiff and
the vanilla DDPM baseline (mirror of ``founddiff_tpu/config.py``).

Defaults are the reference's shipped values (train.py:39-119).  The JSON
form is the JAX package's: a file written by either loads in the other for
the fields both have; a field one side lacks is skipped on load.
"""

from __future__ import annotations

import dataclasses
import json
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
    # with input_condition: only the input image is normalised to [-1, 1],
    # the input condition stays as given (residual.py:457, 561)
    input_condition_mask: bool = False
    self_condition: bool = False
    resnet_block_groups: int = 8
    # the UNets output 2 * channels (unet.py:198-204); the diffusions use
    # the output as it is: the loss broadcasts it, the samplers raise
    learned_variance: bool = False
    base_d_state: int = 4
    ssm_expand: float = 2.0
    clip_backbone: str = "RN50"
    # False: a UnetRes with no Dose-CLIP tower, zero dose/content embeddings
    use_dose_encoder: bool = True
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
    # test(fid=True) at the periodic-eval cadence (src/DADiff.py:1731-1747)
    fid_eval: bool = True
    # mirror metrics.jsonl to wandb when it is importable
    use_wandb: bool = False
    wandb_project: str = "founddiff_tpu"


@dataclasses.dataclass
class DataConfig:
    root: str = "/mnt/miah203/zhchen"
    train_phase: str = "train512"
    test_phase: str = "test"
    subset: str = "multi"
    doses: Tuple[int, ...] = (2, 4, 6, 10)
    num: int = 3000
    stride: int = 2
    # per-anatomy eval slice counts (reference src/DADiff.py:1918-1945)
    eval_counts: Tuple[Tuple[str, int], ...] = (("ab", 290), ("lung", 637), ("head", 159))
    eval_doses: int = 4


@dataclasses.dataclass
class MeshConfig:
    """The ('data', 'seq') process mesh (``founddiff_tpu_torch.parallel``)."""
    data_axis: int = -1  # -1: every rank on the data axis (divided by seq_axis)
    seq_axis: int = 1  # ranks of the sequence-sharded scan


@dataclasses.dataclass
class Config:
    name: str = "FoundDiff"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """Lists become tuples (nested ones too); unknown keys are skipped."""
        subs = {"model": ModelConfig, "diffusion": DiffusionConfig, "train": TrainConfig,
                "data": DataConfig, "mesh": MeshConfig}

        def tup(v):
            return tuple(tup(x) for x in v) if isinstance(v, list) else v

        def build(klass, raw):
            names = {f.name for f in dataclasses.fields(klass)}
            kwargs = {k: build(subs[k], v) if klass is cls and k in subs else tup(v)
                      for k, v in raw.items() if k in names}
            return klass(**kwargs)

        return build(cls, json.loads(text))


def debug_config() -> Config:
    """Tiny-cadence config analogous to the reference's ``debug=True`` branch
    (train.py:48-57)."""
    cfg = Config()
    cfg.train.save_and_sample_every = 2
    cfg.diffusion.sampling_timesteps = 10
    cfg.train.train_num_steps = 200
    return cfg
