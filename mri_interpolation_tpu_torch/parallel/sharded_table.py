"""Hash-table sharding plan (port of the planning half of
``mri_interpolation_tpu/parallel/sharded_table.py``; numpy only).

``plan_table_sharding`` partitions the fused ``(total_size, F)`` table into
per-device slots: a level larger than a device's fair share is split into
one contiguous row range per device (dense levels on whole time-lines, so
the temporal-TV prior stays device-local), the rest are bin-packed whole by
size. ``plan.py`` reads it for ``--plan_devices``. The sharded encode and
trainer that run on such a plan are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..encodings.hashgrid import HashGridEncoding

__all__ = ["TableShardingPlan", "plan_table_sharding"]


@dataclass
class TableShardingPlan:
    """Static slot layout: device -> [(level, start, length)] row-ranges.

    ``start``/``length`` are LEVEL-RELATIVE rows; device arrays below are
    padded to ``n_slots`` slots (length 0 = inert slot) and carry GLOBAL row
    starts (level offset + start) so the encode path works off the oracle's
    global corner ids directly.
    """

    ndev: int
    n_slots: int
    local_rows: int
    slots: List[List[Tuple[int, int, int]]]
    slot_level: np.ndarray   # (ndev, S) int32; 0 pad
    slot_lo: np.ndarray     # (ndev, S) int64 global row start; 0 pad
    slot_len: np.ndarray    # (ndev, S) int64; 0 pad
    slot_off: np.ndarray    # (ndev, S) int64 local row offset; 0 pad
    scatter: np.ndarray     # (ndev*S, L) float32 gathered-slot -> level sum
    tv_mask: np.ndarray     # (ndev, local_rows) f32: rows (r, r+1) time-adjacent
    tv_pairs: int           # total time-adjacent row pairs (all devices)
    n_levels: int
    n_features: int
    dim: int


def plan_table_sharding(enc: HashGridEncoding, n_devices: int) -> TableShardingPlan:
    """Partition the fused table: big levels split by contiguous row-range
    across all devices, the rest greedily bin-packed by size."""
    L, F, d = enc.n_levels, enc.n_features_per_level, enc.input_dim
    sizes = enc.level_sizes.astype(np.int64)
    total = int(sizes.sum())
    fair = -(-total // n_devices)

    slots: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_devices)]
    loads = np.zeros(n_devices, dtype=np.int64)
    big = [l for l in range(L) if int(sizes[l]) > fair]
    small = sorted((l for l in range(L) if int(sizes[l]) <= fair), key=lambda l: -int(sizes[l]))

    for l in big:
        size = int(sizes[l])
        # Dense levels: align split boundaries to whole time-lines (the last
        # axis is fastest-varying in the row-major vertex grid) so every
        # temporal-adjacent vertex pair lives on one device.
        align = int(enc.level_resolutions[l][-1]) + 1 if enc.level_dense[l] else 1
        bounds = [0]
        for i in range(1, n_devices):
            b = int(round(i * size / n_devices / align)) * align
            bounds.append(min(max(b, bounds[-1]), size))
        bounds.append(size)
        for dev in range(n_devices):
            length = bounds[dev + 1] - bounds[dev]
            slots[dev].append((l, bounds[dev], length))
            loads[dev] += length
    for l in small:
        dev = int(np.argmin(loads))
        slots[dev].append((l, 0, int(sizes[l])))
        loads[dev] += sizes[l]
    for s in slots:
        s.sort()

    S = max(1, max(len(s) for s in slots))
    local_rows = max(1, int(loads.max()))

    slot_level = np.zeros((n_devices, S), dtype=np.int32)
    slot_lo = np.zeros((n_devices, S), dtype=np.int64)
    slot_len = np.zeros((n_devices, S), dtype=np.int64)
    slot_off = np.zeros((n_devices, S), dtype=np.int64)
    scatter = np.zeros((n_devices * S, L), dtype=np.float32)
    tv_mask = np.zeros((n_devices, local_rows), dtype=np.float32)
    tv_pairs = 0
    for dev, dev_slots in enumerate(slots):
        cursor = 0
        for j, (l, start, length) in enumerate(dev_slots):
            slot_level[dev, j] = l
            slot_lo[dev, j] = int(enc.level_offsets[l]) + start
            slot_len[dev, j] = length
            slot_off[dev, j] = cursor
            if length > 0:
                scatter[dev * S + j, l] = 1.0
            if length > 1 and enc.level_dense[l]:
                # rows (r, r+1) within the slot are time-adjacent unless r is
                # the last vertex of its time-line.
                vt = int(enc.level_resolutions[l][-1]) + 1
                g = start + np.arange(length - 1)
                adj = (g % vt) != (vt - 1)
                tv_mask[dev, cursor : cursor + length - 1] = adj.astype(np.float32)
                tv_pairs += int(adj.sum())
            cursor += length

    # Alignment invariant: the sharded TV decomposition is exact — every
    # within-line adjacent pair is counted exactly once.
    expected = 0
    for l in range(L):
        if enc.level_dense[l]:
            verts = enc.level_resolutions[l].astype(np.int64) + 1
            if verts[-1] >= 2:
                expected += int(np.prod(verts[:-1]) * (verts[-1] - 1))
    assert tv_pairs == expected, (tv_pairs, expected)

    return TableShardingPlan(
        ndev=n_devices, n_slots=S, local_rows=local_rows, slots=slots,
        slot_level=slot_level, slot_lo=slot_lo, slot_len=slot_len,
        slot_off=slot_off, scatter=scatter, tv_mask=tv_mask, tv_pairs=tv_pairs,
        n_levels=L, n_features=F, dim=d,
    )
