"""The system under test and the reference, built from one configuration
file, and the seeded state dict that both load."""

from __future__ import annotations

import json

import torch

from bench_h100.lib import weights
from bench_h100.reference import model as R

# the tower's options as the program names them -> as the reference does
TOWER = {"backbone_resolution": "resolution", "embed_dim": "embed_dim",
         "vision_layers": "layers", "vision_width": "width",
         "transformer_width": "text_width", "transformer_layers": "text_layers"}


# what the reference implements of each family; another value is refused
IMPLEMENTED = {
    "founddiff": {"model": dict(num_unet=1, objective="pred_res", test_res_or_noise="res",
                                condition=True, input_condition=False, self_condition=False,
                                learned_variance=False, clip_backbone="RN50",
                                use_dose_encoder=True, original_ddim_ddpm=False),
                  "diffusion": dict(loss_type="l2", ddim_sampling_eta=0.0,
                                    ddim_update="use_pred_noise", convert_to_ddim=True,
                                    clip_denoised=True),
                  "train": dict(mixed_precision="no", ema_update_every=10)},
    "vanilla": {"model": dict(original_ddim_ddpm=True, condition=False, self_condition=False,
                              learned_variance=False),
                "train": dict(mixed_precision="no", ema_update_every=10)},
}


def program_config(config: dict):
    from founddiff_tpu_torch.config import Config

    return Config.from_json(json.dumps(config["program"]))


def program(config: dict, device, train: bool, seed: int = 0):
    """``(diffusion, model)`` of the system under test through its factory;
    the benchmark loads its own weights over the factory's."""
    from founddiff_tpu_torch import factory

    cfg = program_config(config)
    if train:
        cfg.train.seed = seed
    diffusion, model = factory.build(cfg, device=device, seed=0,
                                     clip_overrides=tuple(config.get("tower", {}).items()),
                                     train=train)
    return cfg, diffusion, model


def reference(config: dict, device) -> torch.nn.Module:
    for group, fields in IMPLEMENTED[config["family"]].items():
        for k, v in fields.items():
            if config["program"][group].get(k, v) != v:
                raise ValueError(f"{config['name']}: the reference implements {group}.{k} = "
                                 f"{v!r}, not {config['program'][group][k]!r}")
    m = config["program"]["model"]
    kw = dict(dim=m["dim"], dim_mults=tuple(m["dim_mults"]), channels=m["channels"],
              groups=m["resnet_block_groups"])
    with torch.device(device):
        if config["family"] == "vanilla":
            return R.VanillaUnet(**kw)
        tower = {TOWER[k]: v for k, v in config.get("tower", {}).items() if k in TOWER}
        return R.FoundDiff(base_d_state=m["base_d_state"], expand=m["ssm_expand"],
                           tower=tower, **kw)


def state(config: dict, seed: int, device, calibration_slices) -> dict:
    """Seeded weights on ``device``; FoundDiff's tower takes its batch-norm
    statistics from ``calibration_slices`` ([B, H, W, 1] in [0, 1]) on the
    serving path's input (the slice in [-1, 1] as RGB)."""
    st = weights.make_state(reference(config, "meta"), seed, device,
                            config.get("final_scale", 1.0))
    if config["family"] == "founddiff":
        prefix = "unet0.dose_encoder."
        ref = reference(config, device)
        tower = ref.unet0.dose_encoder
        tower.load_state_dict({k[len(prefix):]: v for k, v in st.items() if k.startswith(prefix)})
        x = calibration_slices.float() * 2 - 1
        weights.calibrate_batch_norms(tower, lambda: tower(x.repeat_interleave(3, dim=-1)))
        for k, v in tower.state_dict().items():
            st[prefix + k] = v
        del ref, tower
    return st


class Clock:
    """Laps of set-up on the host clock, the device synchronised at each."""

    def __init__(self, device):
        import time

        self._now, self.cuda = time.perf_counter, str(device) != "cpu"
        self._last, self.laps = self._now(), {}

    def lap(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = self._now()
        self.laps[name] = now - self._last
        self._last = now


def to_host(st: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in st.items()}


def free(device) -> None:
    import gc

    gc.collect()
    if str(device) != "cpu":
        torch.cuda.empty_cache()
