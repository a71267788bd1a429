"""Dense-grid evaluation: the interpolation / super-resolution path.

Port of ``mri_interpolation_tpu/infer/grid.py``: coordinates are made on the
device from flat voxel indices (index -> mixed-radix digits -> linspace
values), so a grid of any shape costs no host grid and no transfer but the
result. The grid is walked in fixed chunks of ``chunk_size`` voxels, the
padded tail repeating the last voxel. Each chunk's coordinates go through
the model's forward, i.e. the hash-encode kernel on the card.

A model with the encode/decode split (:func:`has_split`) whose encoder is all
dense takes the separable ``apply_grid`` path instead, as in the JAX package:
the features of the whole grid are resampled one axis at a time, then decoded
chunk by chunk. Both compute the same function: the tests hold ``apply_grid``
equal to the per-point encode to 1e-6.

``predict_batched`` runs the same chunked forward over an explicit
coordinate matrix (the launcher's periodic eval).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.core import Model

__all__ = ["flat_index_to_coords", "evaluate_grid", "device_eval_seconds", "has_split", "predict_batched"]


def flat_index_to_coords(flat_idx: torch.Tensor, shape: Sequence[int], lo: float = 0.0,
                         hi: float = 1.0) -> torch.Tensor:
    """C-order flat voxel indices -> (N, d) float32 grid coordinates, row
    ``flat_idx`` of ``stack(meshgrid(*[linspace(lo, hi, s)])).reshape(-1, d)``
    in the reference's float32 arithmetic."""
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) >= 2**31:
        raise ValueError(f"grid {shape} exceeds int32 indexing; shard it first")
    strides = np.concatenate([np.cumprod(shape[::-1])[::-1][1:], [1]]).astype(np.int64)
    idx = flat_idx.to(torch.int64)
    coords = []
    for k, size in enumerate(shape):
        digit = (idx // int(strides[k])) % size
        denom = max(size - 1, 1)
        coords.append(lo + (hi - lo) * digit.to(torch.float32) / denom)
    return torch.stack(coords, dim=-1)


def _check_model_on(model: Model, dev: torch.device) -> None:
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model is on {p.device}, the evaluation runs on {dev}")


def _padded_chunk(rows: torch.Tensor, size: int) -> torch.Tensor:
    """``rows`` with its last row repeated up to ``size`` rows."""
    return rows if len(rows) == size else torch.cat([rows, rows[-1:].expand(size - len(rows), -1)])


def _eval_chunks(model: Model, n: int, chunk_size: int, dev: torch.device,
                 chunk_eval: Callable[[int, int], Tuple[torch.Tensor, Optional[torch.Tensor]]]):
    """The model in eval mode on ``n`` rows, ``chunk_size`` a chunk:
    ``chunk_eval(start, stop)`` gives a chunk's output and its latents or
    None (rows past n repeat the last). Returns the (n, dim_out) output and
    the (n, features) latents or None, on the device."""
    chunk_size = min(chunk_size, n)
    n_chunks = -(-n // chunk_size)
    out = torch.empty((n_chunks * chunk_size, model.dim_out), dtype=torch.float32, device=dev)
    latents = None
    was_training = model.training
    model.eval()
    try:
        for c in range(n_chunks):
            start, stop = c * chunk_size, (c + 1) * chunk_size
            y, z = chunk_eval(start, stop)
            out[start:stop] = y
            if z is not None:
                if latents is None:
                    latents = torch.empty((len(out), z.shape[-1]), dtype=torch.float32, device=dev)
                latents[start:stop] = z
    finally:
        model.train(was_training)
    return out[:n], (None if latents is None else latents[:n])


def has_split(model: Model) -> bool:
    """Whether the model exposes the encode/decode split that
    ``return_latents`` and the separable path need."""
    return all(callable(getattr(model, name, None)) for name in ("encode", "decode", "anneal_weights"))


def _decode_weighted(model: Model, z: torch.Tensor) -> torch.Tensor:
    """The decoder on the features weighted by the level anneal, as the
    model's own forward feeds it (the JAX ``_weighted``)."""
    w = model.anneal_weights()
    return model.decode(z if w is None else z * w)


def _grid_on_device(model: Model, shape, lo: float, hi: float, chunk_size: int, dev: torch.device,
                    frame_idx: Optional[int], transform: Optional[Callable], return_latents: bool):
    """The device side of :func:`evaluate_grid`: (n, dim_out) and the raw
    latents (n, features) or None, on ``dev``."""
    n = int(np.prod(shape))
    split = has_split(model) and frame_idx is None
    if return_latents and not split:
        raise ValueError("return_latents requires a model exposing the encode/decode split (the hash families) "
                         "and no frame_idx")
    geometry = getattr(getattr(model, "encoder", None), "geometry", None)
    if (split and transform is None and lo == 0.0 and hi == 1.0 and geometry is not None
            and geometry.supports_grid_path()):
        z = geometry.apply_grid(model.encoder.table.float(), shape, lo, hi)  # (n, L*F), once for the grid
        y, _ = _eval_chunks(model, n, chunk_size, dev,
                            lambda start, stop: (_decode_weighted(model, _padded_chunk(z[start:stop], stop - start)),
                                                 None))
        return y, (z if return_latents else None)

    def chunk_coords(start: int, stop: int) -> torch.Tensor:
        flat = torch.arange(start, stop, device=dev).clamp_(max=n - 1)
        x = flat_index_to_coords(flat, shape, lo, hi)
        return x if transform is None else transform(x)

    def chunk_eval(start: int, stop: int):
        x = chunk_coords(start, stop)
        if not split:
            return model(x, **({} if frame_idx is None else {"frame_idx": frame_idx})), None
        z = model.encode(x)
        return _decode_weighted(model, z), (z if return_latents else None)

    return _eval_chunks(model, n, chunk_size, dev, chunk_eval)


def _quantise_u16(y: torch.Tensor):
    """y against its range on the device: the 16-bit codes
    ``round((y - min) * 65535 / (max - min + 1e-12))`` (half to even), shipped
    as int16 offset by -32768, and the range."""
    vlo, vhi = torch.min(y), torch.max(y)
    q = torch.round((y - vlo) * (65535.0 / (vhi - vlo + 1e-12))).to(torch.int32)
    return (q - 32768).to(torch.int16), vlo, vhi


@torch.no_grad()
def evaluate_grid(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                  chunk_size: int = 1 << 17, device: DeviceLike = None, frame_idx: Optional[int] = None,
                  transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None, return_latents: bool = False,
                  transport: str = "f32"):
    """Evaluate the model in eval mode on a dense grid of ``shape``; returns
    the volume (``shape``, plus a trailing axis when dim_out > 1). The model
    must already be on ``device`` (``cuda`` unless "cpu").

    - ``frame_idx`` selects a multi-frame model's frame;
    - ``transform`` maps each chunk's (chunk, d) coordinates before the
      model sees them (and turns the separable path off);
    - ``return_latents``: also return the raw encoder features as a
      ``shape + (features,)`` array; needs the encode/decode split and no
      ``frame_idx``;
    - ``transport="u16"``: the volume crosses to the host as 16-bit codes
      against its range, dequantised there (one step is (max - min) / 65535).
    """
    if transport not in ("f32", "u16"):
        raise ValueError(f"unknown transport {transport!r}")
    dev = resolve_device(device)
    _check_model_on(model, dev)
    shape = tuple(int(s) for s in shape)
    y, z = _grid_on_device(model, shape, lo, hi, chunk_size, dev, frame_idx, transform, return_latents)

    def to_volume(arr: np.ndarray) -> np.ndarray:
        return arr.reshape(shape) if arr.shape[-1] == 1 else arr.reshape(shape + (arr.shape[-1],))

    if transport == "u16":
        q, vlo, vhi = _quantise_u16(y)
        vlo, vhi = float(vlo), float(vhi)
        codes = q.cpu().numpy().astype(np.int32) + 32768
        vol = codes.astype(np.float32) * ((vhi - vlo) / 65535.0) + vlo
    else:
        vol = y.cpu().numpy()
    if return_latents:
        return to_volume(vol), to_volume(z.cpu().numpy())
    return to_volume(vol)


@torch.no_grad()
def device_eval_seconds(model: Model, shape: Sequence[int], lo: float = 0.0, hi: float = 1.0,
                        chunk_size: int = 1 << 17, iters: int = 3, device: DeviceLike = None,
                        transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> float:
    """Median seconds of the device side of :func:`evaluate_grid` with the
    same arguments (the same path, no copy to the host) over ``iters`` runs
    after one warm-up, each ended by ``torch.cuda.synchronize`` on the card."""
    dev = resolve_device(device)
    _check_model_on(model, dev)
    shape = tuple(int(s) for s in shape)

    def once() -> None:
        _grid_on_device(model, shape, lo, hi, chunk_size, dev, None, transform, False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    once()
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@torch.no_grad()
def predict_batched(model: Model, coords: np.ndarray, chunk_size: int = 1 << 17, device: DeviceLike = None,
                    frame_idx: Optional[int] = None) -> np.ndarray:
    """The model in eval mode on the rows of ``coords`` (N, d), ``chunk_size``
    rows a forward, the padded tail repeating the last row; returns (N,
    dim_out). The model must already be on ``device`` (``cuda`` unless
    "cpu"). ``frame_idx`` selects a multi-frame model's frame."""
    dev = resolve_device(device)
    _check_model_on(model, dev)
    x = torch.as_tensor(np.asarray(coords, dtype=np.float32)).to(dev)
    kwargs = {} if frame_idx is None else {"frame_idx": frame_idx}
    y, _ = _eval_chunks(model, x.shape[0], chunk_size, dev,
                        lambda start, stop: (model(_padded_chunk(x[start:stop], stop - start), **kwargs), None))
    return y.cpu().numpy()
