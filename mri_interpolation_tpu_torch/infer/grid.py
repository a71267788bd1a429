"""Dense-grid evaluation: the interpolation / super-resolution path.

Port of ``mri_interpolation_tpu/infer/grid.py``: coordinates are made on the
device from flat voxel indices (index -> mixed-radix digits -> linspace
values), so a grid of any shape costs no host grid and no transfer but the
result. Every dense evaluation (these, and the parallel evaluators) goes
through one chunk walk, ``_walk``, its padded tail repeating the last voxel
(``ops.hash_mlp_grid.chunk_index``). A request takes one of three routes,
each a writer of the walk chosen once, counted in :data:`ROUTES`:

- ``separable``: a model with the encode/decode split (:func:`has_split`)
  whose encoder is all dense, on a [0, 1] grid with no ``transform``, as in
  the JAX package: the features of the whole grid are resampled one axis at
  a time (``apply_grid``), then decoded chunk by chunk. It computes the same
  function as the per-point encode: the tests hold ``apply_grid`` equal to
  it to 1e-6;
- ``fused_grid``: a model whose ``fused_grid_args()`` gives the op's model
  arguments (a HashMLP with the fused ``relu_plain`` decoder and no level
  anneal), with no ``transform``, ``frame_idx`` or ``return_latents``,
  where the separable route does not apply: a chunk is one call of the op
  ``hash_mlp_grid_forward`` (``ops/hash_mlp_grid.py``), kernel 1 making the
  chunk's coordinates itself and kernel 5 writing the volume's rows, bit
  for bit the ``chunked`` route's volume;
- ``chunked``: everything else: each chunk's coordinates
  (:func:`flat_index_to_coords`) go through the model's forward, the hash
  encoder's kernel on the card, and the output is stored into the volume.

The volume reaches host memory by one of two transfers, counted in
:data:`TRANSFERS`:

- ``pinned``: a request on a CUDA device with ``transport="f32"`` and no
  ``return_latents``. The (n, dim_out) float32 volume goes to a host tensor
  from torch's caching host allocator (``pin_memory=True``), slab by slab:
  after the chunks that fill a slab (whole chunks of about ``_SLAB_BYTES``)
  the device's copy stream waits on the current stream and copies the
  slab's rows (never the padded tail) while later chunks compute. The
  request ends by waiting for the last slab's copy. The returned array is a
  view of that tensor and holds it: every request gets its own, and a
  dropped one returns to the allocator's cache for a later request;
- ``pageable``: every other request (the CPU, ``u16``, which needs the whole
  volume's range first, and ``return_latents``): one copy of the whole
  volume after the last chunk.

``predict_batched`` walks the model's forward over an explicit coordinate
matrix (the launcher's periodic eval).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.core import Model
from ..ops.hash_mlp_grid import chunk_index, flat_index_to_coords, grid_forward
from ..tracing import span

__all__ = ["flat_index_to_coords", "evaluate_grid", "device_eval_seconds", "has_split", "predict_batched",
           "ROUTES", "reset_routes", "TRANSFERS", "reset_transfers"]

# requests (calls of evaluate_grid and runs of device_eval_seconds) by the route they took, counted when the route is
# chosen, in the style of the ops' LAUNCHES
ROUTES = {"separable": 0, "fused_grid": 0, "chunked": 0}


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


# calls of evaluate_grid by how the volume reached host memory, counted when the transfer is chosen
TRANSFERS = {"pinned": 0, "pageable": 0}


def reset_transfers() -> None:
    for name in TRANSFERS:
        TRANSFERS[name] = 0


# a slab of the pinned transfer is the whole chunks of about this many bytes: each slab costs the host an event, a
# wait and a copy launch. On an H100 a (352, 352, 6, 30) grid in 2^17-voxel chunks (512 KiB each) took a median 30.3
# ms a request at 1 chunk a slab, 27.2 at 2, and 22.6-22.9 ms at 4 to 32
_SLAB_BYTES = 4 << 20
_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The device's stream for the volume's copies to the host, made on first use."""
    stream = _COPY_STREAMS.get(dev.index)
    if stream is None:
        stream = _COPY_STREAMS[dev.index] = torch.cuda.Stream(dev)
    return stream


class _PinnedVolume:
    """The pinned transfer's destination ``rows`` (n, dim_out), filled from
    the device's (padded) volume slab by slab on ``stream``."""

    def __init__(self, rows: torch.Tensor, chunk_size: int, stream: "torch.cuda.Stream"):
        self.rows, self.stream = rows, stream
        chunk = min(chunk_size, len(rows))
        self.slab = chunk * max(1, _SLAB_BYTES // (chunk * rows.shape[1] * rows.element_size()))  # rows a slab
        self.copied = 0
        self.done = None  # the event after the last slab's copy

    def stored(self, out: torch.Tensor, stop: int) -> None:
        """Rows [0, stop) of ``out`` are queued on the current stream: copy
        the slab they complete, if they complete one, on the copy stream."""
        stop = min(stop, len(self.rows))
        if stop - self.copied < self.slab and stop < len(self.rows):
            return
        self.stream.wait_stream(torch.cuda.current_stream(out.device))
        with torch.cuda.stream(self.stream):
            self.rows[self.copied:stop].copy_(out[self.copied:stop], non_blocking=True)
        self.done = self.stream.record_event()
        self.copied = stop

    def volume(self) -> np.ndarray:
        """Waits for the last slab's copy; the (n, dim_out) array, a view
        that holds ``rows``."""
        self.done.synchronize()
        return self.rows.numpy()


def _check_model_on(model: Model, dev: torch.device) -> None:
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model is on {p.device}, the evaluation runs on {dev}")


def _padded_chunk(rows: torch.Tensor, size: int) -> torch.Tensor:
    """``rows`` with its last row repeated up to ``size`` rows."""
    return rows if len(rows) == size else torch.cat([rows, rows[-1:].expand(size - len(rows), -1)])


def _walk(model: Model, n: int, chunk_size: int, dev: torch.device, write: Callable[[int, int, torch.Tensor], None],
          host: Optional[_PinnedVolume] = None, n_chunks: Optional[int] = None) -> torch.Tensor:
    """The chunk walk of every dense evaluation: ``n`` rows in chunks of
    ``chunk_size`` (at most n), the model in eval mode (its training flag
    restored after). ``write(start, stop, out)`` fills rows [start, stop) of
    the padded (n_chunks * chunk_size, dim_out) float32 ``out`` on ``dev``,
    under an ``mri.grid.chunk`` span; ``n_chunks`` defaults to the chunks
    that cover n rows (a striped evaluator gives its share). ``host``, if
    given, receives the output's slabs as they are stored. Returns
    ``out[:n]``."""
    chunk_size = min(chunk_size, n)
    n_chunks = -(-n // chunk_size) if n_chunks is None else n_chunks
    out = torch.empty((n_chunks * chunk_size, model.dim_out), dtype=torch.float32, device=dev)
    was_training = model.training
    model.eval()
    try:
        for stop in range(chunk_size, len(out) + 1, chunk_size):
            with span("mri.grid.chunk"):
                write(stop - chunk_size, stop, out)
            if host is not None:
                host.stored(out, stop)
    finally:
        model.train(was_training)
    return out[:n]


def _volume(arr: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """(n, k) rows as a volume of ``shape``, plus a trailing axis when k > 1."""
    return arr.reshape(shape) if arr.shape[-1] == 1 else arr.reshape(shape + (arr.shape[-1],))


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
                    frame_idx: Optional[int], transform: Optional[Callable], return_latents: bool,
                    host: Optional[_PinnedVolume] = None):
    """The device side of :func:`evaluate_grid`: (n, dim_out) and the raw
    latents (n, features) or None, on ``dev``; ``host``, if given, receives
    the volume's slabs as the chunk walk stores them. The route is chosen
    once, as the walk's writer."""
    n = int(np.prod(shape))
    split = has_split(model) and frame_idx is None
    if return_latents and not split:
        raise ValueError("return_latents requires a model exposing the encode/decode split (the hash families) "
                         "and no frame_idx")
    geometry = getattr(getattr(model, "encoder", None), "geometry", None)
    if (split and transform is None and lo == 0.0 and hi == 1.0 and geometry is not None
            and geometry.supports_grid_path()):
        ROUTES["separable"] += 1
        with span("mri.grid.encode"):
            z = geometry.apply_grid(model.encoder.table.float(), shape, lo, hi)  # (n, L*F), once for the grid

        def write(start: int, stop: int, out: torch.Tensor) -> None:
            out[start:stop] = _decode_weighted(model, _padded_chunk(z[start:stop], stop - start))

        return _walk(model, n, chunk_size, dev, write, host), (z if return_latents else None)
    fused = (model.fused_grid_args() if split and transform is None and not return_latents
             and callable(getattr(model, "fused_grid_args", None)) else None)
    if fused is not None:
        ROUTES["fused_grid"] += 1
        table, params, acts, key = fused
        scratch = torch.empty((min(chunk_size, n), params[0].shape[0]), dtype=torch.float32, device=dev)
        grid = list(shape)

        def write(start: int, stop: int, out: torch.Tensor) -> None:
            grid_forward(table, params, acts, key, grid, lo, hi, start, scratch, out)

        return _walk(model, n, chunk_size, dev, write, host), None
    ROUTES["chunked"] += 1
    kwargs = {} if frame_idx is None else {"frame_idx": frame_idx}
    latents = None  # with return_latents: the padded (rows, features) buffer, made at the first chunk

    def write(start: int, stop: int, out: torch.Tensor) -> None:
        nonlocal latents
        x = flat_index_to_coords(chunk_index(start, stop - start, n, dev), shape, lo, hi)
        if transform is not None:
            x = transform(x)
        if not split:
            out[start:stop] = model(x, **kwargs)
            return
        z = model.encode(x)
        out[start:stop] = _decode_weighted(model, z)
        if return_latents:
            if latents is None:
                latents = out.new_empty((len(out), z.shape[-1]))
            latents[start:stop] = z

    y = _walk(model, n, chunk_size, dev, write, host)
    return y, (None if latents is None else latents[:n])


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

    On a CUDA device with ``transport="f32"`` and no ``return_latents`` the
    volume goes to pinned host memory slab by slab while the grid computes
    (the module's ``pinned`` transfer); the array is complete on return.
    """
    if transport not in ("f32", "u16"):
        raise ValueError(f"unknown transport {transport!r}")
    with span("mri.grid.request"):
        dev = resolve_device(device)
        _check_model_on(model, dev)
        shape = tuple(int(s) for s in shape)
        host = None
        if dev.type == "cuda" and transport == "f32" and not return_latents:
            TRANSFERS["pinned"] += 1
            host = _PinnedVolume(torch.empty((int(np.prod(shape)), model.dim_out), dtype=torch.float32,
                                             pin_memory=True), chunk_size, _copy_stream(dev))
        else:
            TRANSFERS["pageable"] += 1
        y, z = _grid_on_device(model, shape, lo, hi, chunk_size, dev, frame_idx, transform, return_latents, host)
        with span("mri.grid.to_host"):
            if host is not None:
                vol = host.volume()
            elif transport == "u16":
                q, vlo, vhi = _quantise_u16(y)
                vlo, vhi = float(vlo), float(vhi)
                codes = q.cpu().numpy().astype(np.int32) + 32768
                vol = codes.astype(np.float32) * ((vhi - vlo) / 65535.0) + vlo
            else:
                vol = y.cpu().numpy()
            latents = z.cpu().numpy() if return_latents else None
        return (_volume(vol, shape), _volume(latents, shape)) if return_latents else _volume(vol, shape)


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

    def write(start: int, stop: int, out: torch.Tensor) -> None:
        out[start:stop] = model(_padded_chunk(x[start:stop], stop - start), **kwargs)

    return _walk(model, x.shape[0], chunk_size, dev, write).cpu().numpy()
