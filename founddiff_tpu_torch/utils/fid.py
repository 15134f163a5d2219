"""FID / Inception-Score utilities (mirror of ``founddiff_tpu/utils/fid.py``).

- :func:`frechet_distance`: the Frechet distance between two gaussians via a
  host float64 eigendecomposition, robust to the rank-deficient covariances
  of small eval batches;
- :func:`fid_from_features` / :func:`compute_fid`: FID given a feature
  extractor.  :func:`make_clip_extractor` builds one from the frozen
  Dose-CLIP RN50 visual tower (no InceptionV3 weights are available offline;
  the statistics are the same for any extractor);
- :func:`inception_score`: IS from class-probability vectors.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _trace_sqrtm_psd_product(s1: np.ndarray, s2: np.ndarray) -> float:
    """tr(sqrtm(s1 @ s2)) for PSD s1, s2: s1 s2 is similar to
    sqrt(s1) s2 sqrt(s1), whose eigenvalues are real and >= 0 up to noise,
    which is clamped to zero."""
    w1, v1 = np.linalg.eigh(s1)
    sq1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = sq1 @ s2 @ sq1
    w = np.linalg.eigvalsh((m + m.T) / 2.0)
    return float(np.sum(np.sqrt(np.clip(w, 0.0, None))))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between N(mu1, sigma1) and N(mu2, sigma2), in float64 on the host."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    offset = eps * np.eye(sigma1.shape[0])
    tr_covmean = _trace_sqrtm_psd_product(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    mu1, s1 = feature_statistics(feats_a)
    mu2, s2 = feature_statistics(feats_b)
    return float(frechet_distance(mu1, s1, mu2, s2))


def make_clip_extractor(tower, batch_size: int = 8) -> Callable:
    """Feature extractor from a frozen Dose-CLIP tower (``models.clip.CLIPIQA``):
    [N, H, W, 1] CT slices in [0, 1] (numpy or tensors) -> [N, embed_dim]
    numpy features, computed on the tower's device.

    Slices are resized to the tower's resolution first, as the JAX extractor
    does with ``jax.image.resize(..., "bilinear")``, which is antialiased
    when it downsamples: here ``F.interpolate(antialias=True,
    align_corners=False)``."""
    res = int(tower.backbone_resolution)
    device = next(tower.parameters()).device

    @torch.no_grad()
    def embed(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=device, dtype=torch.float32)
        if x.shape[1] != res or x.shape[2] != res:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(res, res), mode="bilinear",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
        rgb = (x * 2.0 - 1.0).repeat_interleave(3, dim=-1)
        return tower.clip_model.encode_image(rgb)

    def extract(images) -> np.ndarray:
        images = torch.as_tensor(images)
        outs = [embed(images[i:i + batch_size]).float().cpu().numpy()
                for i in range(0, len(images), batch_size)]
        return np.concatenate(outs, axis=0)

    return extract


def compute_fid(images_a, images_b, extract_fn: Callable) -> float:
    """FID between two image sets given a feature extractor."""
    return fid_from_features(extract_fn(images_a), extract_fn(images_b))


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS from [N, C] class probabilities: exp(E_x KL(p(y|x) || p(y)))."""
    probs = np.asarray(probs, np.float64)
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
