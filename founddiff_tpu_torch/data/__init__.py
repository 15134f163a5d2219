"""Data (mirror of ``founddiff_tpu/data``): the CT datasets and transforms,
the native slice reader, the prefetching loader, and the generation and
restoration image datasets."""

from founddiff_tpu_torch.data.datasets import (
    DOSE_DIRS,
    DoseDataset,
    Mayo16Dataset,
    PDFDataset,
    define_label,
    sorted_list,
)
from founddiff_tpu_torch.data.generation import (
    ImageFolderDataset,
    LSUNLmdbDataset,
    data_transform,
    get_generation_dataset,
    inverse_data_transform,
    logit_transform,
    pad_to_multiple,
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
    "ImageFolderDataset",
    "LSUNLmdbDataset",
    "Loader",
    "Mayo16Dataset",
    "Normalize",
    "PDFDataset",
    "RandomFlip",
    "RandomRotate90",
    "ToArray",
    "cycle",
    "data_transform",
    "define_label",
    "get_generation_dataset",
    "inverse_data_transform",
    "logit_transform",
    "make_paired_transforms",
    "pad_to_multiple",
    "sorted_list",
]
