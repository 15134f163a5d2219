"""CT data layer (mirror of ``founddiff_tpu/data``): numpy/scipy datasets
and transforms, the native slice reader and the prefetching loader."""

from founddiff_tpu_torch.data.datasets import (
    DOSE_DIRS,
    DoseDataset,
    Mayo16Dataset,
    PDFDataset,
    define_label,
    sorted_list,
)
from founddiff_tpu_torch.data.loader import Loader, cycle
from founddiff_tpu_torch.data.transforms import (
    Compose,
    Normalize,
    RandomFlip,
    RandomRotate90,
    ToArray,
    make_paired_transforms,
)

__all__ = [
    "Compose",
    "DOSE_DIRS",
    "DoseDataset",
    "Loader",
    "Mayo16Dataset",
    "Normalize",
    "PDFDataset",
    "RandomFlip",
    "RandomRotate90",
    "ToArray",
    "cycle",
    "define_label",
    "make_paired_transforms",
    "sorted_list",
]
