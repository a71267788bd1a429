"""Inference: dense-grid evaluation."""

from .grid import evaluate_grid, flat_index_to_coords

__all__ = ["evaluate_grid", "flat_index_to_coords"]
