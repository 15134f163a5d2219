"""CT slice datasets (Mayo 2016/2020), a copy of
``founddiff_tpu/data/datasets.py`` — reference data/pdf_dataset.py:279-560,
data/mayo16_dataset.py:26-195, data/dose_dataset.py:25-158.

Deliberate fixes over the reference (documented per SURVEY.md §7):

- data roots are constructor arguments instead of hardcoded cluster paths;
- the default training list is the documented multi-dose union
  (doses 1/2, 1/4, 1/6, 1/10 across ab/lung/head — reference
  data/pdf_dataset.py:344,367,395) instead of the experiment residue
  ``head_dose_1_10_list`` (reference data/pdf_dataset.py:406), which remains
  available as ``subset='head_1_10'``;
- samples are emitted HWC (the package's NHWC layout) rather than CHW.

Pairing semantics are preserved exactly: the NDCT partner is looked up by the
trailing ``-<index>`` of the LDCT filename into the per-anatomy full-dose
list, with a suffix assertion (reference data/pdf_dataset.py:424-448).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

import numpy as np

from founddiff_tpu_torch.data import transforms as T

# dose label -> simulated-dose directory (reference data/pdf_dataset.py:332-340)
DOSE_DIRS: Dict[int, str] = {
    2: "sim-0.50",
    3: "sim-0.33",
    4: "sim-0.25",
    5: "sim-0.20",
    6: "sim-0.17",
    8: "sim-0.12",
    10: "sim-0.10",
    20: "sim-0.05",
}

# anatomies where the reference substitutes the real quarter-dose scan for a
# simulated dose level (reference data/pdf_dataset.py:334,388,395-399)
QUARTER_SUBSTITUTION: Dict[str, int] = {"ab": 4, "lung": 10, "head": 4}

ANATOMY_DIRS: Dict[str, str] = {
    "ab": "Mayo2020_ab_2d",
    "lung": "Mayo2020_lung_2d",
    "head": "Mayo2020_head_2d_2",
}


def sorted_list(pattern: str) -> List[str]:
    out = glob.glob(pattern)
    out.sort()
    return out


def define_label(path: str) -> float:
    """Dose label from a slice path (reference data/pdf_dataset.py:480-511),
    including the lung-quarter->1/10 quirk."""
    if "full_1mm" in path:
        return 1
    if "quarter_1mm" in path:
        return 10 if "lung" in path else 4
    dose = float(path.split("-")[-2])
    return {
        0.5: 2,
        0.33: 3,
        0.25: 4,
        0.20: 5,
        0.2: 5,
        0.17: 6,
        0.12: 8,
        0.10: 10,
        0.1: 10,
        0.05: 20,
    }[dose]


def _load_slice(path: str) -> np.ndarray:
    """Load a 2-D .npy slice as [1, H, W] float32 (the transform chains
    operate on DHW arrays).  Uses the native C++ reader when built."""
    from founddiff_tpu_torch.data import native

    arr = native.read_npy(path)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def _to_hwc(arr: np.ndarray) -> np.ndarray:
    """[C/D, H, W] -> [H, W, C]."""
    return np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))


class PDFDataset:
    """Mayo-2020 multi-anatomy multi-dose paired dataset
    (reference ``PDFDataset`` data/pdf_dataset.py:306-560).

    Returns ``[NDCT, LDCT]`` float32 HWC pairs in [0, 1] (HU-windowed).
    """

    def __init__(
        self,
        phase: str,
        root: str = "/mnt/miah203/zhchen",
        anatomies: Sequence[str] = ("ab", "lung", "head"),
        doses: Sequence[int] = (2, 4, 6, 10),
        num: int = 3000,
        stride: int = 2,
        subset: str = "multi",
        seed: int = T.GLOBAL_SEED,
    ):
        train = "train" in phase
        self.phase = phase
        self.transforms = T.make_paired_transforms(train, seed=seed)

        self.ndct_lists: Dict[str, List[str]] = {}
        per_anatomy: Dict[str, List[str]] = {}
        for anatomy in anatomies:
            base = os.path.join(root, ANATOMY_DIRS[anatomy], phase)
            self.ndct_lists[anatomy] = sorted_list(
                os.path.join(base, "full_1mm", "*")
            )[:num]
            # head lists use stride 1 in the reference (data/pdf_dataset.py:381)
            s = 1 if anatomy == "head" else stride
            files: List[str] = []
            for dose in doses:
                if QUARTER_SUBSTITUTION.get(anatomy) == dose:
                    dose_dir = "quarter_1mm"
                else:
                    dose_dir = DOSE_DIRS[dose]
                files += sorted_list(os.path.join(base, dose_dir, "*"))[:num:s]
            per_anatomy[anatomy] = files

        if subset == "multi":
            self.ldct_paths = [p for a in anatomies for p in per_anatomy[a]]
        elif subset == "head_1_10":
            base = os.path.join(root, ANATOMY_DIRS["head"], phase)
            self.ldct_paths = sorted_list(os.path.join(base, "sim-0.10", "*"))[:num]
        else:
            raise ValueError(f"unknown subset {subset!r}")

    def __len__(self) -> int:
        return len(self.ldct_paths)

    def _ndct_path(self, ldct_path: str) -> str:
        name = os.path.basename(ldct_path)
        anatomy = name.split("-")[0]
        ndct_index = int(ldct_path.split(".")[-2].split("-")[-1])
        ndct_path = self.ndct_lists[anatomy][ndct_index]
        # pairing assertion (reference data/pdf_dataset.py:432-443)
        assert ndct_path.split("-")[-1] == ldct_path.split("-")[-1], (
            ndct_path,
            ldct_path,
        )
        return ndct_path

    def sample_paths(self, index: int) -> List[str]:
        """Files of sample ``index`` (Loader pool-decode protocol)."""
        ldct_path = self.ldct_paths[index]
        return [ldct_path, self._ndct_path(ldct_path)]

    def sample_from_arrays(self, index: int, arrays: Sequence[np.ndarray]):
        """Build the sample from pre-decoded arrays (same order as
        ``sample_paths``); transform RNG order matches ``__getitem__``."""
        ldct, ndct = (a[None] if a.ndim == 2 else a for a in arrays)
        ldct = self.transforms[0](ldct)
        ndct = self.transforms[1](ndct)
        return [_to_hwc(ndct), _to_hwc(ldct)]

    def __getitem__(self, index: int):
        return self.sample_from_arrays(
            index, [_load_slice(p) for p in self.sample_paths(index)]
        )

    def load_name(self, index: int, sub_dir: bool = False) -> str:
        name = self.ldct_paths[index]
        if not sub_dir:
            return os.path.basename(name)
        parent = os.path.basename(os.path.dirname(name))
        return parent + "_" + os.path.basename(name)

    def dose_label(self, index: int) -> float:
        return define_label(self.ldct_paths[index])


class Mayo16Dataset:
    """Mayo-2016 quarter/full paired slices
    (reference data/mayo16_dataset.py:26-195).  ``source='cq500'`` reproduces
    the reference's CQ500 training variant."""

    def __init__(
        self,
        phase: str,
        root: str = "/mnt/miah203/zhchen",
        source: str = "mayo16",
        seed: int = T.GLOBAL_SEED,
    ):
        train = "train" in phase
        self.transforms = T.make_paired_transforms(train, seed=seed)
        if source == "mayo16":
            split = "train" if train else "test"
            base = os.path.join(root, "Mayo2016_2d", split)
            self.q_paths = sorted_list(os.path.join(base, "quarter_1mm", "*"))
            self.f_paths = sorted_list(os.path.join(base, "full_1mm", "*"))
        elif source == "cq500":
            base = os.path.join(root, "CQ500_2d", "test")
            self.q_paths = sorted_list(os.path.join(base, "sim-0.25", "*"))
            self.f_paths = sorted_list(os.path.join(base, "full_1mm", "*"))
        else:
            raise ValueError(f"unknown source {source!r}")

    def __len__(self) -> int:
        return len(self.q_paths)

    def sample_paths(self, index: int) -> List[str]:
        return [self.q_paths[index], self.f_paths[index]]

    def sample_from_arrays(self, index: int, arrays: Sequence[np.ndarray]):
        qa, fa = (a[None] if a.ndim == 2 else a for a in arrays)
        q = self.transforms[0](qa)
        f = self.transforms[1](fa)
        return [_to_hwc(f), _to_hwc(q)]

    def __getitem__(self, index: int):
        return self.sample_from_arrays(
            index, [_load_slice(p) for p in self.sample_paths(index)]
        )

    def load_name(self, index: int, sub_dir: bool = False) -> str:
        name = self.q_paths[index]
        if not sub_dir:
            return os.path.basename(name)
        parent = os.path.basename(os.path.dirname(name))
        return parent + "_" + os.path.basename(name)


class DoseDataset:
    """Two augmentations of one slice + its dose label — training data for
    the Dose-CLIP contrastive/dose head (reference data/dose_dataset.py:25-158)."""

    def __init__(
        self,
        phase: str,
        root: str = "/mnt/miah203/zhchen",
        anatomies: Sequence[str] = ("ab",),
        doses: Sequence[int] = (1, 2, 3, 4, 5, 6, 8, 10, 20),
        num: int = 5000,
        seed: int = T.GLOBAL_SEED,
    ):
        train = "train" in phase
        chain, _ = T.make_paired_transforms(train, seed=seed)
        self.transform = chain
        self.paths: List[str] = []
        anatomy_dirs = {
            "ab": "Mayo2020_ab_2d",
            "lung": "Mayo2020_lung_2d",
            "head": "Mayo2020_head_2d",
        }
        for anatomy in anatomies:
            base = os.path.join(root, anatomy_dirs[anatomy], phase)
            for dose in doses:
                dose_dir = "full_1mm" if dose == 1 else DOSE_DIRS[dose]
                self.paths += sorted_list(os.path.join(base, dose_dir, "*"))[:num]

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int):
        path = self.paths[index]
        arr = _load_slice(path)
        img = [_to_hwc(self.transform(arr)), _to_hwc(self.transform(arr))]
        label = np.float32(define_label(path))
        return img, label
