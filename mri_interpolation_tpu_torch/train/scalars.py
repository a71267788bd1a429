"""Live scalar stream: per-step train-loss records as JSONL.

Port of ``mri_interpolation_tpu/train/scalars.py``, with its record keys and
step numbering: one JSON line per (step, tag, value), appended to
``scalars.jsonl`` in the run directory at each epoch's end (the trainer syncs
with the host once an epoch). ``read_scalars`` reloads it for figures and
tests.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ScalarLogger", "read_scalars"]


class ScalarLogger:
    """Append-only JSONL scalar writer; one line per (step, tag, value)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def log(self, step: int, tag: str, value: float, **extra) -> None:
        rec = {"step": int(step), "tag": tag, "value": float(value), **extra}
        self._fh.write(json.dumps(rec) + "\n")

    def log_epoch_losses(self, epoch: int, first_step: int, losses: np.ndarray,
                         tag: str = "train_loss") -> None:
        """An epoch's per-step loss vector, steps numbered from ``first_step``."""
        lines = [
            json.dumps({"step": int(first_step + i), "epoch": int(epoch), "tag": tag, "value": float(v)})
            for i, v in enumerate(np.asarray(losses).reshape(-1))
        ]
        self._fh.write("\n".join(lines) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(path: str, tag: Optional[str] = None) -> List[Dict]:
    """The records of a scalars.jsonl, in order; only ``tag``'s if given."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if tag is None or rec.get("tag") == tag:
                out.append(rec)
    return out
