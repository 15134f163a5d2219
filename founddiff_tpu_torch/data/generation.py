"""Generation/restoration image datasets (mirror of
``founddiff_tpu/data/generation.py``; reference datasets/ tree):
- ``datasets/base.py`` — folder-of-images dataset with ``condition`` modes
  (0: generation, 1: (gt, input) pairs, 2: (gt, input, input_condition)),
  pad-to-multiple-of-8 and random patch cropping;
- ``datasets/generation/__init__.py`` — CIFAR10/CelebA/LSUN/FFHQ loaders,
  ``data_transform`` / ``inverse_data_transform`` (uniform/gaussian
  dequantization, rescale to [-1,1], logit transform), the CelebA 140x140
  center-crop recipe and FFHQ's seeded 90/10 split.

Images are HWC float32 numpy arrays in [0, 1], drawn in the JAX package's
order from the same seeded ``RandomState``.  PIL, cv2, lmdb and torchvision
are imported only by the functions that need them, and their absence raises
the JAX package's errors; nothing is downloaded.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _open_image(path: str, convert: Optional[str] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if convert:
        img = img.convert(convert)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def pad_to_multiple(arr: np.ndarray, multiple: int = 8) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad H/W up to a multiple (reference datasets/base.py:202-241)."""
    h, w = arr.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return arr, (ph, pw)


class ImageFolderDataset:
    """Folder-of-images dataset with the reference's condition modes."""

    EXTS = ("jpg", "jpeg", "png", "tiff", "bmp")

    def __init__(
        self,
        folder,
        image_size: int,
        condition: int = 0,
        augment_flip: bool = False,
        crop_patch: bool = True,
        convert_image_to: Optional[str] = None,
        sample: bool = False,
        seed: int = 0,
    ):
        self.image_size = image_size
        self.condition = condition
        self.augment_flip = augment_flip
        self.crop_patch = crop_patch
        self.convert = convert_image_to
        self.sample = sample
        self.rng = np.random.RandomState(seed)
        if condition == 0:
            self.paths = self._flist(folder)
        elif condition == 1:
            self.gt = self._flist(folder[0])
            self.input = self._flist(folder[1])
        elif condition == 2:
            self.gt = self._flist(folder[0])
            self.input = self._flist(folder[1])
            self.input_condition = self._flist(folder[2])
        else:
            raise ValueError(condition)

    def _flist(self, folder) -> List[str]:
        if isinstance(folder, (list, tuple)):
            return list(folder)
        if os.path.isdir(folder):
            out = []
            for e in self.EXTS:
                out += glob.glob(os.path.join(folder, f"**/*.{e}"), recursive=True)
            out.sort()
            return out
        return [folder]

    def __len__(self):
        return len(self.input if self.condition else self.paths)

    def _patch(self, imgs: List[np.ndarray]) -> List[np.ndarray]:
        s = self.image_size
        h, w = imgs[0].shape[:2]
        if h <= s and w <= s:
            return imgs
        y = self.rng.randint(0, max(h - s, 0) + 1)
        x = self.rng.randint(0, max(w - s, 0) + 1)
        return [im[y : y + s, x : x + s] for im in imgs]

    def _augment(self, imgs: List[np.ndarray]) -> List[np.ndarray]:
        if self.augment_flip and self.rng.rand() < 0.5:
            imgs = [im[:, ::-1].copy() for im in imgs]
        return imgs

    def __getitem__(self, index: int):
        if self.condition == 0:
            img = _open_image(self.paths[index], self.convert)
            img, _ = pad_to_multiple(img)
            if self.crop_patch and not self.sample:
                (img,) = self._patch([img])
            (img,) = self._augment([img])
            return img
        paths = [self.gt[index], self.input[index]]
        if self.condition == 2:
            paths.append(self.input_condition[index])
        imgs = [_open_image(p, self.convert) for p in paths]
        imgs = [pad_to_multiple(im)[0] for im in imgs]
        if self.crop_patch and not self.sample:
            imgs = self._patch(imgs)
        imgs = self._augment(imgs)
        return imgs


class LSUNLmdbDataset:
    """LSUN lmdb shard reader (reference datasets/generation/lsun.py:13-71):
    keys cached beside the db, JPEG bytes decoded per item, center-cropped to
    the short side and resized to ``image_size``."""

    def __init__(self, db_path: str, image_size: int, augment_flip=False,
                 seed: int = 0):
        import lmdb  # optional; LSUN-only

        self.env = lmdb.open(db_path, max_readers=1, readonly=True, lock=False,
                             readahead=False, meminit=False)
        self.image_size = image_size
        self.augment_flip = augment_flip
        self.rng = np.random.RandomState(seed)
        cache_file = os.path.join(db_path, "_keys_cache.npy")
        if os.path.exists(cache_file):
            self.keys = list(np.load(cache_file, allow_pickle=True))
        else:
            with self.env.begin(write=False) as txn:
                self.keys = [k for k, _ in txn.cursor()]
            np.save(cache_file, np.asarray(self.keys, dtype=object))

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i):
        import cv2

        with self.env.begin(write=False) as txn:
            buf = txn.get(self.keys[i])
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        s = min(h, w)
        y0, x0 = (h - s) // 2, (w - s) // 2
        img = img[y0 : y0 + s, x0 : x0 + s]
        img = cv2.resize(img, (self.image_size, self.image_size),
                         interpolation=cv2.INTER_AREA)
        img = img.astype(np.float32) / 255.0
        if self.augment_flip and self.rng.rand() < 0.5:
            img = img[:, ::-1].copy()
        return img


# ---------------------------------------------------------------------------
# data_transform / inverse_data_transform
# (reference datasets/generation/__init__.py:186-216)
# ---------------------------------------------------------------------------


def logit_transform(image, lam: float = 1e-6):
    image = lam + (1 - 2 * lam) * image
    return np.log(image) - np.log1p(-image)


def data_transform(config, x, rng: Optional[np.random.RandomState] = None):
    rng = rng or np.random
    if getattr(config, "uniform_dequantization", False):
        x = x / 256.0 * 255.0 + rng.uniform(size=x.shape).astype(x.dtype) / 256.0
    if getattr(config, "gaussian_dequantization", False):
        x = x + rng.standard_normal(x.shape).astype(x.dtype) * 0.01
    if getattr(config, "rescaled", False):
        x = 2 * x - 1.0
    elif getattr(config, "logit_transform", False):
        x = logit_transform(x)
    if getattr(config, "image_mean", None) is not None:
        x = x - config.image_mean[None]
    return x


def inverse_data_transform(config, x):
    if getattr(config, "image_mean", None) is not None:
        x = x + config.image_mean[None]
    if getattr(config, "logit_transform", False):
        x = 1.0 / (1.0 + np.exp(-x))
    elif getattr(config, "rescaled", False):
        x = (x + 1.0) / 2.0
    return np.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Named-dataset factory (reference datasets/generation/__init__.py:31-184)
# ---------------------------------------------------------------------------


def get_generation_dataset(name: str, root: str, image_size: int,
                           random_flip: bool = True, category: str = "bedroom"):
    """CIFAR10 / CELEBA / LSUN / FFHQ, returning (train, test) datasets of
    NHWC [0,1] arrays.  torchvision-backed sets require the data to already
    exist under ``root`` (no downloads)."""
    name = name.upper()
    if name == "CIFAR10":
        try:
            from torchvision.datasets import CIFAR10
        except ImportError as e:
            raise RuntimeError("torchvision unavailable for CIFAR10") from e

        def wrap(ds):
            class _W:
                def __len__(self):
                    return len(ds)

                def __getitem__(self, i):
                    img, _ = ds[i]
                    arr = np.asarray(img, np.float32) / 255.0
                    return arr

            return _W()

        train = CIFAR10(os.path.join(root, "cifar10"), train=True, download=False)
        test = CIFAR10(os.path.join(root, "cifar10_test"), train=False,
                       download=False)
        return wrap(train), wrap(test)

    if name == "CELEBA":
        # 128x128 crop around (cx=89, cy=121)
        # (reference datasets/generation/__init__.py:93-99)
        folder = os.path.join(root, "celeba")

        class _CelebA(ImageFolderDataset):
            def __getitem__(self, i):
                img = _open_image(self.paths[i], self.convert)
                # 128x128 crop around (cx=89, cy=121), then resize to
                # image_size (reference datasets/generation/__init__.py:63-99:
                # Crop(cy-64, cy+64, cx-64, cx+64) + transforms.Resize)
                cy, cx = 121, 89
                img = img[cy - 64 : cy + 64, cx - 64 : cx + 64]
                if self.image_size != img.shape[0]:
                    import cv2

                    img = cv2.resize(
                        img, (self.image_size, self.image_size),
                        interpolation=cv2.INTER_LINEAR,
                    )
                (img,) = self._augment([img])
                return img

        ds = _CelebA(folder, image_size, condition=0,
                     augment_flip=random_flip, crop_patch=False)
        test = _CelebA(folder, image_size, condition=0, augment_flip=False,
                       crop_patch=False)
        return ds, test

    if name == "LSUN":
        folder = os.path.join(root, "lsun", f"{category}_train")
        val = os.path.join(root, "lsun", f"{category}_val")
        # the reference reads LSUN's lmdb shards
        # (datasets/generation/lsun.py); use them when present (and the lmdb
        # package is installed), else fall back to extracted image folders
        lmdb_train = folder + "_lmdb"
        if os.path.isdir(lmdb_train):
            return (
                LSUNLmdbDataset(lmdb_train, image_size,
                                augment_flip=random_flip),
                LSUNLmdbDataset(val + "_lmdb", image_size, augment_flip=False),
            )
        return (
            ImageFolderDataset(folder, image_size, augment_flip=random_flip),
            ImageFolderDataset(val, image_size, augment_flip=False),
        )

    if name == "FFHQ":
        ds = ImageFolderDataset(os.path.join(root, "FFHQ"), image_size,
                                augment_flip=random_flip, crop_patch=False)
        n = len(ds)
        indices = list(range(n))
        rs = np.random.RandomState(2019)  # reference seed
        rs.shuffle(indices)
        cut = int(n * 0.9)

        class _Subset:
            def __init__(self, base, idx):
                self.base, self.idx = base, idx

            def __len__(self):
                return len(self.idx)

            def __getitem__(self, i):
                return self.base[self.idx[i]]

        return _Subset(ds, indices[:cut]), _Subset(ds, indices[cut:])

    raise ValueError(f"unknown generation dataset {name!r}")
