"""Build the native IO runtime (``nifti_codec.cc``) with g++.

``python -m mri_interpolation_tpu_torch.native.build`` builds it and prints
the library's path; :func:`build` does the same from Python, and the
codec's entry points call it at first use. The library is named after a
hash of the source and the flags, so an edited source never loads a stale
build, and lands in ``native/_build/`` (listed in ``.gitignore``) through a
temporary file and ``os.replace``, so that processes building at once never
load a half-written file. A missing compiler or a failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "GXX_FLAGS", "library_path", "build", "main"]

SOURCE = Path(__file__).resolve().parent / "nifti_codec.cc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the JAX package's flags (so both codecs round alike), zlib linked by its runtime name
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-l:libz.so.1",)


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return build_dir / f"libmit_native-{digest}.so"


def build(force: bool = False, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the codec unless its library exists (or ``force``); return
    the library's path. Raises RuntimeError when there is no g++ or it
    fails."""
    lib = library_path(build_dir)
    if lib.exists() and not force:
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native NIfTI codec")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        done = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp, *LIBS], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {done.returncode}):\n{done.stdout}{done.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def main() -> int:
    print(f"built {build(force=True)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
