"""TensorBoard event-file writer, dependency-free (a copy of
``mri_interpolation_tpu/train/tb_events.py``; pure Python).

The primary scalar stream is ``scalars.jsonl`` (train/scalars.py); this
module adds TensorBoard compatibility: event files any stock TensorBoard
can open, written without the tensorflow/tensorboard packages by encoding
the two protobuf messages involved by hand.

Wire format (TFRecord): each record is
    uint64 length (LE) | uint32 masked-crc32c(length) |
    payload            | uint32 masked-crc32c(payload)
with crc32c the Castagnoli polynomial and
``mask(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32``.

Payloads are ``tensorflow.Event`` protos. Only the fields TensorBoard's
scalar dashboard reads are emitted:

    Event:   1 wall_time (double) | 2 step (int64) |
             3 file_version (string, first record) | 5 summary (message)
    Summary: 1 value (repeated message)
    Value:   1 tag (string) | 2 simple_value (float)

``export_scalars_jsonl`` converts a run's ``scalars.jsonl`` into an event
file after the fact; ``TBEventWriter`` streams live; ``read_event_file``
decodes one back (crc-verified).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Optional, Tuple

__all__ = ["TBEventWriter", "export_scalars_jsonl", "read_event_file"]

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected, poly 0x82F63B78) — table-driven


def _make_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _field_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _field_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _event_proto(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 scalars: Optional[List[Tuple[str, float]]] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _field_float(2, value))
            for tag, value in scalars)
        msg += _field_bytes(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------


class TBEventWriter:
    """Streams scalar events into ``<logdir>/events.out.tfevents.*``.

    The file opens with the conventional ``brain.Event:2`` version record;
    ``add_scalar`` appends one Event per call. Multiple tags per step are
    fine (each is its own record, as tf.summary does)."""

    def __init__(self, logdir: str, wall_time: Optional[float] = None):
        os.makedirs(logdir, exist_ok=True)
        t = time.time() if wall_time is None else wall_time
        name = f"events.out.tfevents.{int(t)}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._fh = open(self.path, "ab")
        self._fh.write(_record(_event_proto(t, file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        t = time.time() if wall_time is None else wall_time
        self._fh.write(_record(_event_proto(t, step, scalars=[(tag, value)])))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def export_scalars_jsonl(jsonl_path: str, logdir: str,
                         wall_time: Optional[float] = None) -> str:
    """Convert a run's ``scalars.jsonl`` (train/scalars.py) into a
    TensorBoard event file under ``logdir``. Returns the event-file path.

    ``wall_time`` pins every record's timestamp (reproducible artifacts);
    default is now."""
    from .scalars import read_scalars

    recs = read_scalars(jsonl_path)
    with TBEventWriter(logdir, wall_time=wall_time) as w:
        for r in recs:
            w.add_scalar(r["tag"], r["value"], r["step"],
                         wall_time=wall_time)
    return w.path


# ---------------------------------------------------------------------------
# independent decoder (test oracle + debugging)


def read_event_file(path: str) -> Iterator[dict]:
    """Decode an event file back into dicts (crc-verified). Yields
    ``{"wall_time": ..., "step": ..., "file_version": ... | "scalars":
    [(tag, value), ...]}`` per record."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(data[off:off + 8]):
            raise ValueError(f"header crc mismatch at offset {off}")
        payload = data[off + 12:off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"payload crc mismatch at offset {off}")
        off += 12 + ln + 4
        yield _decode_event(payload)


def _read_varint(b: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        n |= (b[i] & 0x7F) << shift
        shift += 7
        i += 1
        if not b[i - 1] & 0x80:
            return n, i


def _iter_fields(b: bytes) -> Iterator[Tuple[int, int, object]]:
    i = 0
    while i < len(b):
        key, i = _read_varint(b, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(b, i)
        elif wire == 1:
            v = struct.unpack_from("<d", b, i)[0]
            i += 8
        elif wire == 5:
            v = struct.unpack_from("<f", b, i)[0]
            i += 4
        elif wire == 2:
            ln, i = _read_varint(b, i)
            v = b[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _decode_event(b: bytes) -> dict:
    out: dict = {"wall_time": None, "step": 0}
    for field, _wire, v in _iter_fields(b):
        if field == 1:
            out["wall_time"] = v
        elif field == 2:
            out["step"] = v
        elif field == 3:
            out["file_version"] = v.decode()
        elif field == 5:
            scalars = []
            for f2, _w2, v2 in _iter_fields(v):
                if f2 != 1:
                    continue
                tag, val = None, None
                for f3, _w3, v3 in _iter_fields(v2):
                    if f3 == 1:
                        tag = v3.decode()
                    elif f3 == 2:
                        val = v3
                scalars.append((tag, val))
            out["scalars"] = scalars
    return out
