"""Numpy CT transforms (a copy of ``founddiff_tpu/data/transforms.py``;
reference data/transforms.py).

Host-side, numpy-only augmentation pipeline.  The key invariant is *paired*
augmentation: the LDCT and NDCT chains hold independently-constructed
``np.random.RandomState`` objects seeded identically (reference
data/pdf_dataset.py:521-560, data/transforms.py:11-12), so geometric
transforms stay in lockstep between input and target as long as both chains
are applied once per sample.

The HU normalization window is the load-bearing detail for metric parity
(reference data/transforms.py:572-587): ``m -= 1024`` then
``clip((m + 1000)/3000, 0, 1)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates, rotate

GLOBAL_SEED = 47


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, m):
        for t in self.transforms:
            m = t(m)
        return m


class RandomFlip:
    """Random flips over axes (0,1,2) of a DHW/CDHW array; flip happens when
    ``uniform() > axis_prob`` (reference data/transforms.py:25-51)."""

    def __init__(self, random_state, axis_prob: float = 0.5, **kwargs):
        assert random_state is not None
        self.random_state = random_state
        self.axes = (0, 1, 2)
        self.axis_prob = axis_prob

    def __call__(self, m):
        assert m.ndim in (3, 4)
        for axis in self.axes:
            if self.random_state.uniform() > self.axis_prob:
                if m.ndim == 3:
                    m = np.flip(m, axis)
                else:
                    m = np.stack([np.flip(m[c], axis) for c in range(m.shape[0])])
        return m


class RandomRotate90:
    """k*90-degree rotation in the (1,2) plane (reference data/transforms.py:54-82)."""

    def __init__(self, random_state, **kwargs):
        self.random_state = random_state
        self.axis = (1, 2)

    def __call__(self, m):
        assert m.ndim in (3, 4)
        k = self.random_state.randint(0, 4)
        if m.ndim == 3:
            return np.rot90(m, k, self.axis)
        return np.stack([np.rot90(m[c], k, self.axis) for c in range(m.shape[0])])


class RandomRotate:
    """Free-angle rotation (reference data/transforms.py:85-117)."""

    def __init__(self, random_state, angle_spectrum=30, axes=None, mode="reflect",
                 order=0, **kwargs):
        self.random_state = random_state
        self.angle_spectrum = angle_spectrum
        self.axes = axes if axes is not None else [(1, 0), (2, 1), (2, 0)]
        self.mode = mode
        self.order = order

    def __call__(self, m):
        axis = self.axes[self.random_state.randint(len(self.axes))]
        angle = self.random_state.randint(-self.angle_spectrum, self.angle_spectrum)
        if m.ndim == 3:
            return rotate(m, angle, axes=axis, reshape=False, order=self.order,
                          mode=self.mode, cval=-1)
        return np.stack(
            [rotate(c, angle, axes=axis, reshape=False, order=self.order,
                    mode=self.mode, cval=-1) for c in m]
        )


class RandomContrast:
    """alpha-scaled contrast around the mean (reference data/transforms.py:120-141)."""

    def __init__(self, random_state, alpha=(0.5, 1.5), mean=0.0,
                 execution_probability=0.1, **kwargs):
        self.random_state = random_state
        self.alpha = alpha
        self.mean = mean
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            alpha = self.random_state.uniform(self.alpha[0], self.alpha[1])
            result = self.mean + alpha * (m - self.mean)
            return np.clip(result, -1, 1)
        return m


class ElasticDeformation:
    """B-spline-ish elastic deformation via gaussian-filtered displacement
    fields (reference data/transforms.py:144-193)."""

    def __init__(self, random_state, spline_order=3, alpha=2000, sigma=50,
                 execution_probability=0.1, apply_3d=True, **kwargs):
        self.random_state = random_state
        self.spline_order = spline_order
        self.alpha = alpha
        self.sigma = sigma
        self.execution_probability = execution_probability
        self.apply_3d = apply_3d

    def __call__(self, m):
        if self.random_state.uniform() >= self.execution_probability:
            return m
        assert m.ndim in (3, 4)
        volume_shape = m.shape if m.ndim == 3 else m[0].shape
        if self.apply_3d:
            dz = gaussian_filter(
                self.random_state.randn(*volume_shape), self.sigma, mode="reflect"
            ) * self.alpha
        else:
            dz = np.zeros_like(m)
        dy, dx = (
            gaussian_filter(
                self.random_state.randn(*volume_shape), self.sigma, mode="reflect"
            ) * self.alpha
            for _ in range(2)
        )
        z_dim, y_dim, x_dim = volume_shape
        z, y, x = np.meshgrid(
            np.arange(z_dim), np.arange(y_dim), np.arange(x_dim), indexing="ij"
        )
        indices = z + dz, y + dy, x + dx
        if m.ndim == 3:
            return map_coordinates(m, indices, order=self.spline_order, mode="reflect")
        return np.stack(
            [map_coordinates(c, indices, order=self.spline_order, mode="reflect")
             for c in m]
        )


class CropToFixed:
    """Random or centered fixed-size crop with reflect padding when too small
    (reference data/transforms.py:196-249)."""

    def __init__(self, random_state, size=(256, 256), centered=False, **kwargs):
        self.random_state = random_state
        self.crop_y, self.crop_x = size
        self.centered = centered

    def __call__(self, m):
        # mirrors the reference exactly (data/transforms.py:203-249): randint
        # over an EXCLUSIVE [0, max-crop) range, randint is ALWAYS consumed
        # (range 1 when padding — keeps paired-RNG lockstep), and the
        # too-small case pads SYMMETRICALLY (half before, half after)
        def _padding(pad_total):
            half = pad_total // 2
            return (half, pad_total - half)

        def _rand_range_and_pad(crop, size):
            if crop < size:
                return size - crop, (0, 0)
            return 1, _padding(crop - size)

        def _start_and_pad(crop, size):
            if crop < size:
                return (size - crop) // 2, (0, 0)
            return 0, _padding(crop - size)

        def volume_pad(m, pady, padx):
            if m.ndim == 4:
                return np.pad(m, ((0, 0), (0, 0), pady, padx), mode="reflect")
            return np.pad(m, ((0, 0), pady, padx), mode="reflect")

        y, x = m.shape[-2:]
        if not self.centered:
            y_range, pady = _rand_range_and_pad(self.crop_y, y)
            x_range, padx = _rand_range_and_pad(self.crop_x, x)
            y_start = self.random_state.randint(y_range)
            x_start = self.random_state.randint(x_range)
        else:
            y_start, pady = _start_and_pad(self.crop_y, y)
            x_start, padx = _start_and_pad(self.crop_x, x)
        result = m[..., y_start : y_start + self.crop_y, x_start : x_start + self.crop_x]
        if pady != (0, 0) or padx != (0, 0):
            result = volume_pad(result, pady, padx)
        return result


class Standardize:
    """(m - mean) / std (reference data/transforms.py:520-543)."""

    def __init__(self, eps=1e-10, mean=None, std=None, channelwise=False, **kwargs):
        self.mean, self.std, self.eps, self.channelwise = mean, std, eps, channelwise

    def __call__(self, m):
        if self.mean is not None:
            mean, std = self.mean, self.std
        elif self.channelwise:
            axes = tuple(range(1, m.ndim))
            mean = np.mean(m, axis=axes, keepdims=True)
            std = np.std(m, axis=axes, keepdims=True)
        else:
            mean, std = np.mean(m), np.std(m)
        return (m - mean) / np.clip(std, self.eps, None)


class PercentileNormalizer:
    def __init__(self, pmin=1, pmax=99.6, channelwise=False, eps=1e-10, **kwargs):
        self.pmin, self.pmax, self.channelwise, self.eps = pmin, pmax, channelwise, eps

    def __call__(self, m):
        if self.channelwise:
            axes = tuple(range(1, m.ndim))
            pmin = np.percentile(m, self.pmin, axis=axes, keepdims=True)
            pmax = np.percentile(m, self.pmax, axis=axes, keepdims=True)
        else:
            pmin = np.percentile(m, self.pmin)
            pmax = np.percentile(m, self.pmax)
        return (m - pmin) / (pmax - pmin + self.eps)


class Normalize:
    """The HU window (reference data/transforms.py:572-587): subtract the
    1024 scanner offset, window [-1000, 2000] HU, scale to [0, 1]."""

    def __init__(self, min_value: float = -1000, max_value: float = 2000, **kwargs):
        assert max_value > min_value
        self.min_value = min_value
        self.value_range = max_value - min_value

    def __call__(self, m):
        m = m - 1024
        norm01 = (m - self.min_value) / self.value_range
        return np.clip(norm01, 0, 1)


class AdditiveGaussianNoise:
    def __init__(self, random_state, scale=(0.0, 1.0), execution_probability=0.1,
                 **kwargs):
        self.random_state = random_state
        self.scale = scale
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            std = self.random_state.uniform(self.scale[0], self.scale[1])
            return m + self.random_state.normal(0, std, size=m.shape)
        return m


class AdditivePoissonNoise:
    def __init__(self, random_state, lam=(0.0, 1.0), execution_probability=0.1,
                 **kwargs):
        self.random_state = random_state
        self.lam = lam
        self.execution_probability = execution_probability

    def __call__(self, m):
        if self.random_state.uniform() < self.execution_probability:
            lam = self.random_state.uniform(self.lam[0], self.lam[1])
            return m + self.random_state.poisson(lam, size=m.shape)
        return m


class ToArray:
    """Finalize to float32 (analogue of the reference's ToTensor,
    data/transforms.py:618-634); adds a channel axis when requested."""

    def __init__(self, expand_dims: bool = False, dtype=np.float32, **kwargs):
        self.expand_dims = expand_dims
        self.dtype = dtype

    def __call__(self, m):
        assert m.ndim in (3, 4)
        if self.expand_dims and m.ndim == 3:
            m = np.expand_dims(m, axis=0)
        return np.ascontiguousarray(m, dtype=self.dtype)


def make_paired_transforms(
    train: bool,
    min_value: float = -1000,
    max_value: float = 2000,
    seed: int = GLOBAL_SEED,
):
    """Two transform chains with lockstep RNG for (LDCT, NDCT)
    (reference data/pdf_dataset.py:521-560)."""
    base = np.random.RandomState(seed)
    shared_seed = base.randint(10000000)
    rs1 = np.random.RandomState(shared_seed)
    rs2 = np.random.RandomState(shared_seed)

    def chain(rs):
        if train:
            return Compose(
                [
                    RandomFlip(rs),
                    RandomRotate90(rs),
                    Normalize(min_value=min_value, max_value=max_value),
                    ToArray(expand_dims=False),
                ]
            )
        return Compose(
            [
                Normalize(min_value=min_value, max_value=max_value),
                ToArray(expand_dims=False),
            ]
        )

    return chain(rs1), chain(rs2)
