"""Move a JAX parameter/state tree into the port.

The port keeps the JAX package's layouts (dense weights (dim_in, dim_out),
the fused (T, F) hash table, BatchNorm scale/bias/mean/var), so the move is
a tree-map with no transposes: nested dicts and lists flatten into a
``state_dict`` with "."-joined keys, e.g. ``params["layers"][0]["w"]`` ->
``"layers.0.w"`` and ``state["bn"][1]["var"]`` -> ``"bn.1.var"``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _flatten(prefix: str, node: Any, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(node, dict):
        for key, child in node.items():
            _flatten(f"{prefix}{key}.", child, out)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _flatten(f"{prefix}{i}.", child, out)
    else:
        name = prefix[:-1]
        if name in out:
            raise ValueError(f"duplicate key {name!r} between params and state")
        out[name] = torch.from_numpy(np.array(node, copy=True))


def params_from_jax(params_np: Any, state_np: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model.load_state_dict`` from the JAX params and
    state pytrees (leaves as numpy arrays, e.g. after ``jax.device_get``)."""
    out: Dict[str, torch.Tensor] = {}
    _flatten("", params_np, out)
    if state_np:
        _flatten("", state_np, out)
    return out
