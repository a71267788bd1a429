"""Inference: dense-grid evaluation and chunked prediction."""

from .grid import evaluate_grid, flat_index_to_coords, predict_batched

__all__ = ["evaluate_grid", "flat_index_to_coords", "predict_batched"]
