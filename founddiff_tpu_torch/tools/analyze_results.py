"""Offline result analysis (mirror of ``tools/analyze_results.py``; reference
test.ipynb, cells 1-3): PSNR / SSIM / RMSE of the ``.npy`` predictions that
``Trainer.test`` writes against the ground-truth slices of the same names,
per anatomy and dose, and optionally HU-windowed PNGs of them:

    python -m founddiff_tpu_torch.tools.analyze_results <pred_dir> <gt_dir> \\
        [--window -160 240] [--export-figs out/] [--device cuda]

Prints the JSON report ``{"<anatomy>/dose_1_<dose>": {n, psnr, ssim,
rmse}}``, each mean rounded to 4 decimals.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def window(x01: np.ndarray, lo: float, hi: float) -> np.ndarray:
    hu = np.clip(x01 * 3000.0 - 1000.0, lo, hi)
    return (hu - lo) / (hi - lo)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pred_dir")
    p.add_argument("gt_dir")
    p.add_argument("--window", nargs=2, type=float, default=(-160, 240))
    p.add_argument("--export-figs", default=None)
    p.add_argument("--limit", type=int, default=100000)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the metrics (default: the card; 'cpu' on the host)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from founddiff_tpu_torch.data.datasets import define_label
    from founddiff_tpu_torch.ops.metrics import compute_psnr, compute_rmse, compute_ssim
    from founddiff_tpu_torch.utils.device import resolve
    from founddiff_tpu_torch.utils.images import save_image

    device = resolve(args.device, "analyze_results")
    preds = sorted(glob.glob(os.path.join(args.pred_dir, "*.npy")))[:args.limit]
    if not preds:
        raise SystemExit(f"no predictions in {args.pred_dir}")
    by_group: dict = {}
    for pth in preds:
        name = os.path.basename(pth)
        gt_path = os.path.join(args.gt_dir, name)
        if not os.path.exists(gt_path):
            continue
        pred = np.load(pth).astype(np.float32)
        gt = np.load(gt_path).astype(np.float32)
        if pred.ndim == 2:
            pred, gt = pred[None, ..., None], gt[None, ..., None]
        a, b = (torch.from_numpy(v).to(device) for v in (pred, gt))
        m = tuple(float(f(a, b)) for f in (compute_psnr, compute_ssim, compute_rmse))
        anatomy = name.split("-")[0]
        try:
            dose = define_label(pth)
        except Exception:
            dose = "?"
        by_group.setdefault((anatomy, dose), []).append(m)
        if args.export_figs:
            os.makedirs(args.export_figs, exist_ok=True)
            lo, hi = args.window
            save_image(window(pred, lo, hi), os.path.join(args.export_figs, name[:-4] + ".png"),
                       nrow=1)
    report = {}
    for (anatomy, dose), ms in sorted(by_group.items()):
        arr = np.asarray(ms)
        report[f"{anatomy}/dose_1_{dose}"] = {
            "n": len(ms),
            "psnr": round(float(arr[:, 0].mean()), 4),
            "ssim": round(float(arr[:, 1].mean()), 4),
            "rmse": round(float(arr[:, 2].mean()), 4),
        }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
