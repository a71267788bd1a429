"""IO layer: NIfTI codec + volume -> coordinate-dataset construction (numpy)."""

from . import nifti
from .volume import (
    VoxelDataset,
    dataset_from_array,
    even_frame_split,
    even_frame_training_set,
    flat_coords,
    load_volume,
    make_mgrid,
    normalize_intensity,
    synthetic_volume,
)

__all__ = [
    "nifti",
    "VoxelDataset",
    "dataset_from_array",
    "even_frame_split",
    "even_frame_training_set",
    "flat_coords",
    "load_volume",
    "make_mgrid",
    "normalize_intensity",
    "synthetic_volume",
]
