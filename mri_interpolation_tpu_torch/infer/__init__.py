"""Inference: dense-grid evaluation, chunked prediction, the serving export,
the classical interpolation baselines and motion-compensated registration."""

from .classical import cubic_interpolate_frames, linear_interpolate_volume, temporal_upsample_classical
from .export import export_evaluator_bytes, load_evaluator, quantize_tables, save_evaluator
from .grid import device_eval_seconds, evaluate_grid, flat_index_to_coords, has_split, predict_batched
from .registration import (group_motion_upsample, motion_compensated_upsample, register_group_temporal, register_pair,
                           synthesize_frame, warp_frame)

__all__ = ["evaluate_grid", "device_eval_seconds", "flat_index_to_coords", "has_split", "predict_batched",
           "linear_interpolate_volume", "cubic_interpolate_frames", "temporal_upsample_classical", "register_pair",
           "register_group_temporal", "synthesize_frame", "warp_frame", "motion_compensated_upsample",
           "group_motion_upsample", "save_evaluator", "load_evaluator", "export_evaluator_bytes", "quantize_tables"]
