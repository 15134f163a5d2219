"""Full-volume CT denoising over a ('data', 'seq') mesh of ranks (mirror of
``tools/denoise_volume.py``, BASELINE config 5).

Loads a checkpoint, builds the mesh over every rank (one per card under
``torchrun``), and denoises a ``[Z, H, W]`` ``.npy`` volume with its slices
split over 'data' and, with ``--seq`` above 1, every SS2D selective scan
split over 'seq' (:mod:`founddiff_tpu_torch.parallel.sequence`):

    python -m founddiff_tpu_torch.tools.denoise_volume volume.npy out.npy \\
        --checkpoint checkpoints/FoundDiff/sample/model-400.pt [--torch] \\
        [--seq 2] [--batch_per_device 1] [--steps 2] [--bf16] [--device cuda]
    torchrun --nproc_per_node 4 -m founddiff_tpu_torch.tools.denoise_volume ... --seq 2

Rank 0 writes the output and prints the summary line, slices/s and the mesh.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Denoise a CT volume with the EMA weights of a checkpoint",
        epilog="Orbax checkpoint directories are the JAX package's and are not read here.")
    p.add_argument("volume", help="[Z, H, W] or [Z, H, W, 1] .npy in [0, 1]")
    p.add_argument("output")
    p.add_argument("--checkpoint", required=True,
                   help="a model-<n>.pt: the port's Trainer.save file or, with --torch, a "
                        "reference one (the same layout; both read by Trainer.load_torch)")
    p.add_argument("--torch", action="store_true",
                   help="the checkpoint is a reference model-<n>.pt")
    p.add_argument("--seq", type=int, default=1, help="sequence-parallel mesh axis size")
    p.add_argument("--batch_per_device", type=int, default=1)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if os.path.isdir(args.checkpoint):
        raise SystemExit(f"{args.checkpoint} is a directory: Orbax checkpoints are the JAX "
                         "package's; pass a model-<n>.pt")

    import numpy as np
    import torch
    import torch.distributed as dist

    from founddiff_tpu_torch.config import Config
    from founddiff_tpu_torch.factory import build
    from founddiff_tpu_torch.parallel import init_distributed, make_mesh
    from founddiff_tpu_torch.pipeline import make_volume_denoiser
    from founddiff_tpu_torch.train.trainer import Trainer

    device = init_distributed(args.device)
    vol = np.load(args.volume).astype(np.float32)
    if vol.ndim == 3:
        vol = vol[..., None]
    if vol.ndim != 4 or vol.shape[-1] != 1:
        raise SystemExit(f"volume of shape {vol.shape}: want [Z, H, W] or [Z, H, W, 1]")

    cfg = Config()
    cfg.diffusion.image_size = vol.shape[1]
    cfg.diffusion.sampling_timesteps = args.steps
    diffusion, model = build(cfg, device=device, train=True)
    trainer = Trainer(diffusion, model, cfg)
    trainer.load_torch(args.checkpoint)

    mesh = make_mesh(seq=args.seq)
    denoise = make_volume_denoiser(trainer.ema, diffusion, mesh,
                                   batch_per_device=args.batch_per_device,
                                   compute_dtype=torch.bfloat16 if args.bf16 else None)
    x = torch.from_numpy(vol).to(device)
    t0 = time.perf_counter()
    out = denoise(x, generator=torch.Generator().manual_seed(0))
    out = out.float().cpu().numpy()  # waits for the card
    dt = time.perf_counter() - t0
    if not dist.is_initialized() or dist.get_rank() == 0:
        np.save(args.output, out[..., 0])
        print(f"denoised {vol.shape[0]} slices @ {vol.shape[1]}^2 in {dt:.1f}s "
              f"({vol.shape[0] / dt:.3f} slices/s) over mesh {mesh.shape} -> {args.output}")


if __name__ == "__main__":
    main()
