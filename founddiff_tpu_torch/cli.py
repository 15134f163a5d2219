"""Command line of the port: the two modes of the JAX ``train.py``
(train.py:20-188), training on the Mayo-2020 tree or testing a checkpoint.

    python -m founddiff_tpu_torch --name FoundDiff --is_train --data_root DIR
    python -m founddiff_tpu_torch --name FoundDiff --epoch 400 --dataset 2020_seen
    python -m founddiff_tpu_torch --name X --torch_checkpoint model-400.pt
    torchrun --nproc_per_node 4 -m founddiff_tpu_torch --name X --is_train --mesh_data 4

The flags are ``train.py``'s, with ``--device`` (the card by default; ``cpu``
runs the plain versions) and without ``--scan_impl``.  Under ``torchrun``
each rank takes ``cuda:LOCAL_RANK`` and NCCL (gloo with ``--device cpu``),
and a ('data', 'seq') mesh is built as ``train.py`` builds it
(train.py:113-131): data-parallel training, every rank computing the test.
Checkpoints and logs go to ``checkpoints/<name>`` under the working directory.
"""

from __future__ import annotations

import argparse
import os

EPILOG = ("Not taken from train.py: --scan_impl (the port routes each MambaBlock as the "
          "JAX package does on a TPU, by grid and width).")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FoundDiff training/testing on an NVIDIA card",
                                epilog=EPILOG)
    p.add_argument("--name", type=str, required=True, help="experiment name")
    p.add_argument("--is_train", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--sampling_timesteps", type=int, default=2)
    p.add_argument("--epoch", type=int, default=100, help="checkpoint milestone to load")
    p.add_argument("--dataset", type=str, default="2020_seen",
                   choices=["2020_seen", "2020_unseen", "2016_unseen"])
    p.add_argument("--train_num_steps", type=int, default=200000)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--data_root", type=str, default="/mnt/miah203/zhchen")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--original_ddim_ddpm", action="store_true",
                   help="vanilla DDPM/DDIM baseline path (reference train.py:59)")
    p.add_argument("--no_dose_encoder", action="store_true")
    p.add_argument("--num_unet", type=int, default=1)
    p.add_argument("--objective", type=str, default="pred_res")
    p.add_argument("--test_res_or_noise", type=str, default="res")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--dim", type=int, default=64,
                   help="UNet base width (reference train.py:98; shrink for CPU runs)")
    p.add_argument("--dim_mults", type=str, default="1,2,4,8",
                   help="comma-separated UNet width multipliers")
    p.add_argument("--torch_checkpoint", type=str, default="",
                   help="load a reference PyTorch model-<n>.pt")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel mesh axis size (0 = auto: all ranks / seq)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def build_config(opt):
    from founddiff_tpu_torch.config import Config

    cfg = Config()
    cfg.name = opt.name
    cfg.model.original_ddim_ddpm = opt.original_ddim_ddpm
    cfg.model.use_dose_encoder = not opt.no_dose_encoder and not opt.original_ddim_ddpm
    cfg.model.num_unet = opt.num_unet
    cfg.model.dim = opt.dim
    cfg.model.dim_mults = tuple(int(m) for m in opt.dim_mults.split(","))
    cfg.model.objective = opt.objective
    cfg.model.test_res_or_noise = opt.test_res_or_noise
    if opt.original_ddim_ddpm:
        cfg.model.condition = False
    cfg.diffusion.image_size = opt.image_size
    cfg.diffusion.sampling_timesteps = opt.sampling_timesteps
    cfg.train.train_num_steps = opt.train_num_steps
    cfg.train.train_batch_size = opt.train_batch_size
    cfg.train.checkpoint_folder = os.path.join("checkpoints", opt.name)
    cfg.data.root = opt.data_root
    if opt.debug:
        cfg.train.save_and_sample_every = 2
        cfg.diffusion.sampling_timesteps = min(cfg.diffusion.sampling_timesteps, 10)
        # don't clobber an explicitly shorter run
        cfg.train.train_num_steps = min(cfg.train.train_num_steps, 200)
    return cfg


def _pdf(cfg, phase, doses=None):
    from founddiff_tpu_torch.data import PDFDataset

    d = cfg.data
    return PDFDataset(phase, root=d.root, subset=d.subset,
                      doses=d.doses if doses is None else doses, num=d.num, stride=d.stride)


def main(argv=None):
    """Runs one mode; returns its ``Trainer``."""
    opt = parse_args(argv)
    cfg = build_config(opt)

    import torch.distributed as dist

    from founddiff_tpu_torch.data import Mayo16Dataset
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.parallel import init_distributed, make_mesh
    from founddiff_tpu_torch.train.trainer import Trainer
    from founddiff_tpu_torch.utils.logger import get_logger

    os.makedirs(cfg.train.checkpoint_folder, exist_ok=True)
    # torchrun's rendezvous, then a ('data', 'seq') mesh when more than one
    # rank runs or a layout is asked for (train.py:119-131)
    device = init_distributed(opt.device)
    mesh = None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if opt.mesh_data or cfg.mesh.seq_axis > 1 or world > 1:
        data = opt.mesh_data or (cfg.mesh.data_axis if cfg.mesh.data_axis > 0 else None)
        mesh = make_mesh(data=data, seq=cfg.mesh.seq_axis)
    diffusion, model = build(cfg, device=device, train=True)

    if opt.is_train:
        trainer = Trainer(diffusion, model, cfg,
                          train_dataset=_pdf(cfg, cfg.data.train_phase),
                          sample_dataset=_pdf(cfg, cfg.data.test_phase), mesh=mesh)
        if opt.torch_checkpoint:
            trainer.load_torch(opt.torch_checkpoint)
        trainer.train()
        return trainer

    # test path (reference train.py:161-182)
    if opt.dataset == "2016_unseen":
        test_ds = Mayo16Dataset("test", root=cfg.data.root)
        suffix = "test_final_2016"
    elif opt.dataset == "2020_unseen":
        test_ds = _pdf(cfg, cfg.data.test_phase, doses=(3, 5, 8, 20))
        suffix = "test_final_unseen"
    else:
        test_ds = _pdf(cfg, cfg.data.test_phase)
        suffix = "test_final"

    trainer = Trainer(diffusion, model, cfg, sample_dataset=test_ds, mesh=mesh)
    if opt.torch_checkpoint:
        trainer.load_torch(opt.torch_checkpoint)
    else:
        trainer.load(opt.epoch)
    out_dir = os.path.join(cfg.train.checkpoint_folder, suffix + "_npy")
    os.makedirs(out_dir, exist_ok=True)
    trainer.train_logger = get_logger(os.path.join(cfg.train.checkpoint_folder, suffix + ".log"))
    trainer.results_folder = out_dir
    trainer.test(last=True, save_npy=True)
    return trainer
