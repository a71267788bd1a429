"""Process groups: the port's counterpart of ``mri_interpolation_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``jax.sharding.Mesh`` over the chips of one
host and lets ``shard_map`` run one program on all of them. In PyTorch each
rank is a process of a ``torch.distributed`` group: :func:`make_mesh`
describes the group a rank is in (:class:`RankGroup`: the process group,
its size, the rank, the rank's device), and the collectives here take that
description. With no group initialised the world is one rank and a
collective is the identity, which is where the launcher's single-device
branches go.

:func:`init_from_env` joins the group that ``torchrun`` describes in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL for ``cuda``, gloo for ``cpu``. :class:`RankPool`
starts ``k`` processes joined in a group and runs the calls it is handed on
all of them, paying the processes' start once (the tests on the CPU, and
two ranks sharing one card over gloo in ``chip_smoke.py``).

The JAX names ``Mesh``, ``NamedSharding``, ``P``, ``replicated`` and
``sharded_batch`` are shardings of arrays; a torch rank holds its own
tensors, so they have no counterpart.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

__all__ = ["RankGroup", "make_mesh", "world_size", "init_from_env", "all_reduce_sum_", "mean_over_ranks", "all_gather",
           "RankPool"]


@dataclass(frozen=True)
class RankGroup:
    """One rank's view of its group: ``group`` (None: a world of one rank
    with no process group), ``world_size``, ``rank`` and the ``device`` this
    rank computes on."""

    group: Optional[Any]
    world_size: int
    rank: int
    device: torch.device


def world_size() -> int:
    """The default group's size; 1 when ``torch.distributed`` is not initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_device(device: DeviceLike, rank: int, world: int) -> torch.device:
    """``device``; for ``None`` or an unindexed ``"cuda"`` in a group of
    more than one rank, ``cuda:LOCAL_RANK`` (else ``cuda:rank`` modulo the
    cards)."""
    if world > 1 and (device is None or str(device) == "cuda") and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        return resolve_device(f"cuda:{local % torch.cuda.device_count()}")
    return resolve_device(device)


def make_mesh(n_devices: Optional[int] = None, device: DeviceLike = None) -> Optional[RankGroup]:
    """This rank's :class:`RankGroup` over the first ``n_devices`` ranks of
    the default group (all by default). Without an initialised group the
    world is this process alone. Asking for more ranks than exist raises
    ``ValueError``, as ``jax.devices()`` does in the JAX package. With
    ``n_devices`` below the world size every rank of the default group must
    call this (``torch.distributed.new_group`` is collective), and a rank
    outside the first ``n_devices`` gets None. ``device``: where this rank
    computes (``cuda`` unless "cpu"; see :func:`_rank_device`). An
    initialised group of one rank is used as it is: its collectives run."""
    world = world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if not dist.is_initialized():
        return RankGroup(None, 1, 0, resolve_device(device))
    rank = dist.get_rank()
    group = dist.group.WORLD
    if n_devices is not None and n_devices < world:
        group = dist.new_group(list(range(n_devices)))
        if rank >= n_devices:
            return None
        world = n_devices
    return RankGroup(group, world, rank, _rank_device(device, rank, world))


def init_from_env(device: DeviceLike = None) -> bool:
    """Join the group that ``torchrun`` describes in the environment, if it
    describes one of more than one rank and none is initialised yet: NCCL
    when ``device`` is CUDA (``cuda:LOCAL_RANK`` becomes the current
    device), gloo when it is "cpu". Returns whether it initialised one."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(_rank_device(device, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])))
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    return True


def all_reduce_sum_(mesh: RankGroup, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group, in place (one ``all_reduce``; nothing
    with no process group)."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def mean_over_ranks(mesh: RankGroup, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each of ``tensors`` averaged over the group (a sum, then a division
    by the world size, as JAX's ``pmean``) in one ``all_reduce`` of one flat
    buffer: views of that buffer, one a tensor, in their shapes. With no
    process group, the tensors themselves."""
    if mesh.group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    if mesh.world_size > 1:
        flat /= mesh.world_size
    return [chunk.view_as(t) for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors]))]


def all_gather(mesh: RankGroup, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t``, stacked in rank order on a new leading axis (one
    ``all_gather``)."""
    if mesh.group is None:
        return t.unsqueeze(0)
    out = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(out, t.contiguous(), group=mesh.group)
    return torch.stack(out)


def _rank_main(rank: int, world: int, init_method: str, backend: str, threads: Optional[int], inbox, outbox) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        while True:
            job = inbox.get()
            if job is None:
                return
            fn, args = job
            try:
                outbox.put((rank, True, fn(*args)))
            except Exception:  # the caller raises it; the rank takes the next call
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` spawned processes joined in one process group
    (``backend``, through a file store in a temporary directory), each
    running the calls it is handed in turn.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` and
    ``args`` are pickled: ``fn`` must be a module-level function) and
    returns the ranks' results in rank order. An exception on a rank is
    raised here with the rank's traceback, and a call that does not end
    within ``timeout`` seconds on every rank (a rank stuck in a collective
    that another left) stops the pool and raises ``TimeoutError``.
    ``threads`` sets each rank's ``torch.set_num_threads``. ``close`` (or
    the end of a ``with`` block) ends the processes."""

    def __init__(self, world_size: int, backend: str = "gloo", threads: Optional[int] = None, timeout: float = 600.0):
        ctx = multiprocessing.get_context("spawn")
        self.world_size, self.timeout = world_size, timeout
        self._dir = tempfile.TemporaryDirectory(prefix="rank_pool_")
        init_method = f"file://{os.path.join(self._dir.name, 'store')}"
        self._inboxes = [ctx.Queue() for _ in range(world_size)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, args=(r, world_size, init_method, backend, threads,
                                                             self._inboxes[r], self._outbox), daemon=True)
                       for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args) -> List:
        if not self._procs:
            raise RuntimeError("the pool is closed")
        for inbox in self._inboxes:
            inbox.put((fn, args))
        results: List = [None] * self.world_size
        failures = []
        for _ in range(self.world_size):
            try:
                rank, ok, value = self._outbox.get(timeout=self.timeout)
            except queue.Empty:
                self.close(wait=False)
                raise TimeoutError(f"{getattr(fn, '__name__', fn)} did not end on every rank in {self.timeout} s")
            results[rank] = value
            if not ok:
                failures.append(f"rank {rank}:\n{value}")
        if failures:
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on {len(failures)} rank(s):\n"
                               + "\n".join(failures))
        return results

    def close(self, wait: bool = True) -> None:
        if wait:
            for inbox in self._inboxes:
                inbox.put(None)
            for p in self._procs:
                p.join(timeout=60)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        self._dir.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
