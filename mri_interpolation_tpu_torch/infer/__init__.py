"""Inference: dense-grid evaluation and chunked prediction."""

from .grid import device_eval_seconds, evaluate_grid, flat_index_to_coords, has_split, predict_batched

__all__ = ["evaluate_grid", "device_eval_seconds", "flat_index_to_coords", "has_split", "predict_batched"]
