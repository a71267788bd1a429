"""Move a JAX parameter/state tree into the port.

The port keeps the JAX package's layouts (dense weights (dim_in, dim_out),
the fused (T, F) hash table, BatchNorm scale/bias/mean/var), so the move is
a tree-map with no transposes: nested dicts and lists flatten into a
``state_dict`` with "."-joined keys, e.g. ``params["layers"][0]["w"]`` ->
``"layers.0.w"`` and ``state["bn"][1]["var"]`` -> ``"bn.1.var"``. A
Python ``bool`` leaf (the complex GaborNet's per-layer ``"complex"`` flag)
is a static attribute in the port, not a tensor, and is skipped. A
stacked tree (a leading axis of V parameter sets) becomes V of them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

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
    elif isinstance(node, bool):
        return
    else:
        name = prefix[:-1]
        if name in out:
            raise ValueError(f"duplicate key {name!r} between params and state")
        out[name] = torch.from_numpy(np.array(node, copy=True))


def params_from_jax(params_np: Any, state_np: Optional[Any] = None,
                    stacked: bool = False) -> Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """A ``state_dict`` for ``model.load_state_dict`` from the JAX params and
    state pytrees (leaves as numpy arrays, e.g. after ``jax.device_get``).
    ``stacked``: every leaf carries a leading axis of V parameter sets (the
    JAX ``fit_multi_volume``'s ``jax.vmap(model.init)``); returns V
    ``state_dict``s, set v from row v of every leaf."""
    out: Dict[str, torch.Tensor] = {}
    _flatten("", params_np, out)
    if state_np:
        _flatten("", state_np, out)
    if not stacked:
        return out
    sets = {t.shape[0] for t in out.values()}
    if len(sets) != 1:
        raise ValueError(f"the leaves' leading axes differ: {sorted(sets)}")
    return [{k: t[v].clone() for k, t in out.items()} for v in range(sets.pop())]
