"""PNG and GIF writers (numpy and zlib only), and the image mappings the
port's figures use.

The JAX package draws its figures through matplotlib (``imshow``, titles,
axes) and writes its GIF through imageio; the port's runtime has neither,
so it writes the pixels itself:

- :func:`write_png`: 8-bit grayscale (H, W) or RGB (H, W, 3) arrays as
  PNG (the signature, IHDR, ``tEXt`` chunks, one zlib IDAT of rows each
  with filter byte 0, IEND; chunk CRCs by ``zlib.crc32``). Text that
  matplotlib would draw (titles, panel labels, axis ranges) goes into
  ``tEXt`` chunks, keyword and text in Latin-1, since there is no font
  renderer;
- :func:`write_gif`: 8-bit grayscale frames as an animated GIF89a (a
  256-level gray global palette, the NETSCAPE looping extension, a
  graphic-control extension with the frame delay, and each frame's pixels
  LZW-compressed with variable code widths of 9 to 12 bits, a clear code
  when the table is full);
- :data:`VIRIDIS`: matplotlib's ``viridis`` colormap as the 256 RGB bytes
  ``colormaps["viridis"](range(256), bytes=True)`` gives, kept here as a
  constant, and :data:`GRAY` a 256-level gray ramp; :func:`colorize` maps an array
  min-max onto such a table as matplotlib's ``Colormap`` indexes
  (``floor(x * 256)``, 1.0 to the last entry);
  :func:`to_gray` maps min-max to ``uint8`` as the JAX package's GIF
  frames do (``(x * 255).astype(uint8)``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["write_png", "write_gif", "VIRIDIS", "GRAY", "colorize", "to_gray"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# matplotlib's viridis, colormaps["viridis"](np.arange(256), bytes=True)[:, :3], row-major RGB
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), dtype=np.uint8).reshape(256, 3)
# a gray ramp, entry i is (i, i, i) (matplotlib's gray, whose bytes truncate, is within one level of it)
GRAY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _unit(a: np.ndarray, lo: Optional[float] = None, hi: Optional[float] = None) -> np.ndarray:
    """``a`` min-max normalised to [0, 1] in float64 (0 where it is flat)."""
    a = np.asarray(a, dtype=np.float64)
    lo = float(a.min()) if lo is None else lo
    hi = float(a.max()) if hi is None else hi
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def colorize(a: np.ndarray, table: np.ndarray = VIRIDIS) -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8: min-max onto ``table``'s entries, entry
    ``floor(x * N)`` for x in [0, 1) and the last one for x = 1."""
    n = len(table)
    idx = np.clip(np.floor(_unit(a) * n), 0, n - 1).astype(np.intp)
    return table[idx]


def to_gray(a: np.ndarray, lo: Optional[float] = None, hi: Optional[float] = None) -> np.ndarray:
    """Min-max (over ``a``, or the range given) to uint8 as
    ``(x * 255).astype(uint8)`` with x = (a - lo) / (hi - lo + 1e-12)."""
    a = np.asarray(a)
    lo = float(a.min()) if lo is None else lo
    hi = float(a.max()) if hi is None else hi
    return ((a - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, image: np.ndarray, text: Optional[Dict[str, str]] = None) -> str:
    """Write an 8-bit (H, W) gray or (H, W, 3) RGB image as PNG, with one
    ``tEXt`` chunk per ``text`` entry (keywords of 1-79 Latin-1 characters).
    Returns ``path``."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3) images, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    out = [_PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    for key, value in (text or {}).items():
        if not 1 <= len(key) <= 79:
            raise ValueError(f"a PNG text keyword has 1-79 characters: {key!r}")
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + str(value).encode("latin-1")))
    out += [_chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def _lzw_encode(pixels: bytes, min_code_size: int = 8) -> bytes:
    """GIF's LZW: codes of ``min_code_size + 1`` bits growing to 12, packed
    least significant bit first; the clear code first and whenever the
    table reaches 4096 codes, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    width, next_code = min_code_size + 1, end + 1
    table = {bytes([i]): i for i in range(clear)}
    acc = nbits = 0
    out = bytearray()

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = b""
    for value in pixels:
        word = prefix + bytes([value])
        if word in table:
            prefix = word
            continue
        emit(table[prefix])
        if next_code == 4096:  # the table is full: start over
            emit(clear)
            table = {bytes([i]): i for i in range(clear)}
            width, next_code = min_code_size + 1, end + 1
        else:
            table[word] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        prefix = bytes([value])
    if prefix:
        emit(table[prefix])
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int = 200, loop: int = 0) -> str:
    """Write equal-shape uint8 (H, W) frames as an animated gray GIF: each
    pixel's value is its palette index, the palette 256 grays, each frame
    shown ``duration_ms`` (in GIF's hundredths of a second); ``loop`` 0
    repeats forever. Returns ``path``."""
    frames = [np.asarray(f) for f in frames]
    if not frames or any(f.dtype != np.uint8 or f.ndim != 2 or f.shape != frames[0].shape for f in frames):
        raise ValueError("write_gif takes one or more uint8 (H, W) frames of one shape")
    h, w = frames[0].shape
    palette = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette,
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    delay = int(round(duration_ms / 10))
    for f in frames:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        data = _lzw_encode(np.ascontiguousarray(f).tobytes())
        out.append(b"\x08" + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                      for i in range(0, len(data), 255)) + b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path
