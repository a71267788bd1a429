"""Spans of the port's layers, on the clock of torch.profiler's trace.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
torch.profiler session records, and one shared no-op context otherwise, so
an untraced run never enters ``record_function``. A span goes through the
profiler: it lands in the same Kineto trace as the device's kernels and
copies, on the same clock, and every exporter of that trace carries it
(``utils.capture_trace``, the benchmark's ``--trace 1`` window). Its parent
is the span around it on the calling thread. Nothing is stored here.

Whether a span records is decided when it is entered: one entered before
the profiler starts stays off; one still open when the profiler stops exits
cleanly. A layer's counts are its spans' counts in a trace (steps, chunks,
launches, syncs).

:data:`SPANS` names every span once:

- ``mri.train.shuffle``: an epoch's permutation and index view
  (``Trainer.fit``);
- ``mri.train.step``: one step of ``Trainer.fit`` or ``fit_streaming``:
  the batch, ``forward``, ``backward``, ``optimizer`` and storing the loss;
- ``mri.train.forward``: the step's loss;
- ``mri.train.backward``: ``zero_grad``, ``backward`` and the ranks' mean;
- ``mri.train.optimizer``: the whole update chain (schedule and Adam);
- ``mri.train.sync``: the epoch's one copy of its losses to the host;
- ``mri.train.hooks``: the epoch hooks;
- ``mri.model.psf_expand``: the PSF SIREN's expansion of a batch's voxel
  centres into their B*K offset points (``PsfSiren.psf_loss``);
- ``mri.model.psf_integrate``: its Gaussian weighted sum of the K
  predictions of each voxel and the MSE against the targets;
- ``mri.grid.request``: one ``evaluate_grid`` call;
- ``mri.grid.encode``: the separable route's ``apply_grid`` of the whole grid;
- ``mri.grid.chunk``: one writer call of the chunk walk (``infer.grid._walk``,
  also under ``predict_batched`` and the parallel evaluators); by route
  (``infer.grid.ROUTES``): ``fused_grid``, the one call of the op
  ``hash_mlp_grid_forward`` (kernel 1 makes the coordinates, kernel 5
  stores the rows); ``chunked``, the coordinates, the model's forward and
  the store into the volume; ``separable``, the decoder on the chunk's rows
  of the grid's features and the store;
- ``mri.grid.to_host``: by the request's transfer
  (``infer.grid.TRANSFERS``): ``pinned``, the wait for the last slab's copy
  to pinned host memory (the slabs before it were copied while the chunks
  computed); ``pageable``, the volume's (and latents') copy to host memory,
  the 16-bit quantisation included: the wait for queued work and the copy;
- ``mri.op.launch``: a kernel's ctypes launch, inside the dispatcher's
  ``mri_torch::*`` event;
- ``mri.op.build``: a first-use build or load of the kernels' libraries.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["SPANS", "span"]

SPANS = (
    "mri.train.shuffle",
    "mri.train.step",
    "mri.train.forward",
    "mri.train.backward",
    "mri.train.optimizer",
    "mri.train.sync",
    "mri.train.hooks",
    "mri.model.psf_expand",
    "mri.model.psf_integrate",
    "mri.grid.request",
    "mri.grid.encode",
    "mri.grid.chunk",
    "mri.grid.to_host",
    "mri.op.launch",
    "mri.op.build",
)

_OFF = contextlib.nullcontext()  # reentrant and reusable: one object for every span that does not record


def span(name: str):
    """A context over ``name`` (a constant of :data:`SPANS`): a
    ``record_function`` while the profiler records, else a shared no-op."""
    return torch.profiler.record_function(name) if torch.autograd.profiler._is_profiler_enabled else _OFF
