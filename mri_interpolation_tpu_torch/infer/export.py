"""Serving export: a trained model's dense-grid evaluator as one
``torch.export`` program, saved as a ``.pt2`` file.

Port of ``mri_interpolation_tpu/infer/export.py``, which exports a
zero-argument StableHLO function that scans every chunk of the grid. Here
the program is ONE chunk: its input is a 0-d int64 ``start``; in the graph
it makes ``flat = min(start + arange(chunk), n - 1)`` (``chunk_index``),
the coordinates (``flat_index_to_coords``) and the model's output in eval
mode, with the parameters and buffers saved beside the graph and a
multi-frame model's ``frame_idx`` fixed. The loader walks the chunks in
Python and trims the padded tail. ``start`` stays a tensor: an int would be
specialised, one program a chunk.

The file is a ``.pt2`` archive (``torch.export.save``), not StableHLO, with
``evaluator.json`` (shape, lo, hi, chunk size, n, dim_out, device, table
dtype, frame) among its extra files. Loading needs torch and this package's
``ops`` (imported here: importing it registers the kernels' ops that the
graph calls), not the model's code or a checkpoint. A program runs on the
device type it was exported for (``device``: the card unless "cpu"; the JAX
``platforms=``); a card artifact loaded where there is no card raises.

    save_evaluator("eval.pt2", model, (352, 352, 30))
    vol = load_evaluator("eval.pt2")()  # np.ndarray of the shape
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops  # noqa: F401  (registers torch.ops.mri_torch.*, which the programs call)
from ..device import DeviceLike, resolve_device
from ..models.core import Model
from ..ops.hash_mlp_grid import chunk_index, flat_index_to_coords
from .grid import _check_model_on, _volume

__all__ = ["save_evaluator", "load_evaluator", "export_evaluator_bytes", "quantize_tables"]

_META = "evaluator.json"


def quantize_tables(model: Model, dtype: torch.dtype = torch.bfloat16) -> Model:
    """A copy of ``model`` whose parameters named ``table`` (the hash
    families' tables: megabytes against the decoder's kilobytes) are cast to
    ``dtype``; every other parameter and buffer is untouched.

    bf16 keeps float32's exponent with 8 mantissa bits: it halves the
    artifact's table bytes, while the encode stays float32 (the models read
    a narrower table as float32 before the kernel, the JAX package's
    "gathered rows promote on first use"). A serving-side cast, after the
    fit: the copy is not meant for training."""
    out = copy.deepcopy(model)
    for module in out.modules():
        table = module._parameters.get("table")
        if table is not None:
            module.table = nn.Parameter(table.detach().to(dtype), requires_grad=table.requires_grad)
    return out


class _ChunkProgram(nn.Module):
    """One chunk of the grid: ``start`` (0-d int64) -> (chunk, dim_out)."""

    def __init__(self, model: Model, shape: Tuple[int, ...], lo: float, hi: float, chunk: int,
                 frame_idx: Optional[int]):
        super().__init__()
        self.model = model
        self.shape, self.lo, self.hi, self.chunk, self.frame_idx = shape, lo, hi, chunk, frame_idx
        self.n = int(np.prod(shape))

    def forward(self, start: torch.Tensor) -> torch.Tensor:
        x = flat_index_to_coords(chunk_index(start, self.chunk, self.n, start.device), self.shape, self.lo, self.hi)
        return self.model(x) if self.frame_idx is None else self.model(x, frame_idx=self.frame_idx)


def _export(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0, chunk_size: int = 1 << 15,
            frame_idx: Optional[int] = None, device: DeviceLike = None, table_dtype: Optional[torch.dtype] = None):
    dev = resolve_device(device)
    _check_model_on(model, dev)
    if table_dtype is not None:
        model = quantize_tables(model, table_dtype)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    chunk = min(int(chunk_size), n)
    program = _ChunkProgram(model, shape, float(lo), float(hi), chunk, frame_idx)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            exported = torch.export.export(program, (torch.zeros((), dtype=torch.int64, device=dev),), strict=False)
    finally:
        model.train(was_training)
    meta = {"shape": list(shape), "lo": float(lo), "hi": float(hi), "chunk_size": chunk, "n": n,
            "dim_out": int(model.dim_out), "device": dev.type, "frame_idx": frame_idx,
            "table_dtype": None if table_dtype is None else str(table_dtype).replace("torch.", "")}
    return exported, meta


def export_evaluator_bytes(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                           chunk_size: int = 1 << 15, frame_idx: Optional[int] = None, device: DeviceLike = None,
                           table_dtype: Optional[torch.dtype] = None) -> bytes:
    """The dense-grid evaluator of ``model`` (on ``device``) over ``shape``
    as the bytes of a ``.pt2`` archive. ``table_dtype``: cast the hash tables
    in the saved parameters (``torch.bfloat16`` halves them; see
    :func:`quantize_tables`)."""
    exported, meta = _export(model, shape, lo, hi, chunk_size, frame_idx, device, table_dtype)
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def save_evaluator(path: str, model: Model, shape: Sequence[int], **kw) -> str:
    """Write :func:`export_evaluator_bytes`' archive (the same keywords) to
    ``path``; returns it."""
    exported, meta = _export(model, shape, **kw)
    torch.export.save(exported, path, extra_files={_META: json.dumps(meta)})
    return path


def _read_meta(path: str) -> dict:
    with zipfile.ZipFile(path) as archive:
        names = [name for name in archive.namelist() if name.endswith(f"/extra/{_META}")]
        if len(names) != 1:
            raise ValueError(f"{path} holds no {_META}: not an evaluator saved by save_evaluator")
        return json.loads(archive.read(names[0]))


def load_evaluator(path: str) -> Callable[[], np.ndarray]:
    """Load a saved evaluator; returns ``fn() -> np.ndarray`` of the exported
    grid shape (a trailing axis kept where dim_out > 1). Raises where the
    artifact's device type is absent (a card artifact without a card)."""
    meta = _read_meta(path)
    dev = resolve_device(meta["device"])
    program = torch.export.load(path).module()
    shape, n, chunk = tuple(meta["shape"]), meta["n"], meta["chunk_size"]
    n_chunks = -(-n // chunk)

    def fn() -> np.ndarray:
        with torch.no_grad():
            starts = torch.arange(n_chunks, dtype=torch.int64, device=dev) * chunk
            out = torch.empty((n_chunks * chunk, meta["dim_out"]), dtype=torch.float32, device=dev)
            for c in range(n_chunks):
                out[c * chunk:(c + 1) * chunk] = program(starts[c])
            vol = out[:n].cpu().numpy()
        return _volume(vol, shape)

    return fn
