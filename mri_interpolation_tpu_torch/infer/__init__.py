"""Inference: dense-grid evaluation, chunked prediction and the classical
interpolation baselines."""

from .classical import cubic_interpolate_frames, linear_interpolate_volume, temporal_upsample_classical
from .grid import device_eval_seconds, evaluate_grid, flat_index_to_coords, has_split, predict_batched

__all__ = ["evaluate_grid", "device_eval_seconds", "flat_index_to_coords", "has_split", "predict_batched",
           "linear_interpolate_volume", "cubic_interpolate_frames", "temporal_upsample_classical"]
