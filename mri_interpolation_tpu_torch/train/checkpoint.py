"""Checkpoint save and restore.

Port of ``mri_interpolation_tpu/train/checkpoint.py`` in the port's own
format (``torch.save``, not orbax): ``directory/step_N.pt`` holds ``{"step":
N, "model": state_dict}`` (parameters and buffers: BatchNorm statistics, the
level-anneal counter) and, from the trainer's epoch hooks, ``"optimizer"``,
the optimizer state (Adam's moments and counts, the schedule's update count,
a gradient-accumulation window in progress). Restoring reads tensors and
plain containers only (``weights_only``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def save_checkpoint(directory: str, step: int, model_state: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict[str, Any]] = None) -> str:
    """Write ``directory/step_{step}.pt`` (replacing one of the same step);
    returns its path. The file appears whole or not at all."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{int(step)}.pt")
    payload = {"step": int(step), "model": model_state}
    if optimizer_state is not None:
        payload["optimizer"] = optimizer_state
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the ``step_N.pt`` files in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        stem, ext = os.path.splitext(name)
        if ext == ".pt" and stem.startswith("step_") and stem[5:].isdigit():
            steps.append(int(stem[5:]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location: Any = "cpu") -> Dict[str, Any]:
    """``{"step", "model"[, "optimizer"]}`` of ``directory/step_{step}.pt``
    (default: the latest step), its tensors on ``map_location``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{int(step)}.pt")
    return torch.load(path, map_location=map_location, weights_only=True)
