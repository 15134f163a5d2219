"""Image utilities: HU preview window and PNG grid saving (mirror of
``founddiff_tpu/utils/images.py``).

The reference saves training previews after remapping the [0,1] output back
through the HU window ``clip(x*3000-1000, -160, 240)`` then ``(x+160)/400``
(reference src/DADiff.py:1794-1795), via torchvision's ``save_image`` grid.
"""

from __future__ import annotations

import numpy as np


def hu_preview_window(x: np.ndarray) -> np.ndarray:
    """[0,1]-normalized CT -> display window [-160, 240] HU -> [0,1]."""
    hu = np.clip(np.asarray(x) * 3000.0 - 1000.0, -160.0, 240.0)
    return (hu + 160.0) / 400.0


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """torchvision-style image grid for NHWC arrays in [0, 1]."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        dtype=images.dtype,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = images[idx]
    return grid


def save_image(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """Save an NHWC [0,1] batch as one PNG grid (PIL when available,
    else raw .npy next to the requested path)."""
    grid = make_grid(np.asarray(images, dtype=np.float32), nrow=nrow)
    arr = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:
        np.save(path + ".npy", arr)
