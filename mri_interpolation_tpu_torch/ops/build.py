"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (raw pointers, sizes, a
``cudaStream_t``) and includes no PyTorch header, so ``nvcc`` builds it in
seconds. The shared library is named after a hash of its source and flags,
so an edited source never loads a stale build. All sources that still need a
build are compiled in parallel, one ``nvcc`` each, at the first call to
:func:`load`; nothing is built at import time.

The build directory, ``ops/_build/``, is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "H100_SMS", "find_nvcc", "compile_sources", "load", "build_logs",
           "sm_count", "check_tensor"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = {name: _CSRC / f"{name}.cu" for name in ("hash_encode", "fused_mlp", "probe")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the SMs of an H100 SXM: the kernels' host plans assume it where no card is asked
H100_SMS = 132

_loaded: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else the toolkit's default location, else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def _lib_path(name: str, src: Path, build_dir: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"lib{name}-{digest}.so"


def compile_sources(sources: Dict[str, Path], build_dir: Path = BUILD_DIR,
                    nvcc: Optional[str] = None) -> Dict[str, Path]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    at once; return {name: library path}. Raises RuntimeError with
    ``nvcc``'s output if one fails."""
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")
    build_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: _lib_path(name, src, build_dir) for name, src in sources.items()}
    procs = {}
    try:
        for name, src in sources.items():
            if libs[name].exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failures = []
        for name, (proc, tmp) in procs.items():
            output, _ = proc.communicate()
            _logs[name] = output
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {sources[name]} (exit {proc.returncode}):\n{output}")
                os.unlink(tmp)
            else:
                os.replace(tmp, libs[name])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; the first call builds every source that
    is not built yet, in parallel. The caller declares argtypes."""
    lib = _loaded.get(name)
    if lib is None:
        pending = {n: s for n, s in SOURCES.items() if n not in _loaded}
        for n, path in compile_sources(pending).items():
            _loaded[n] = ctypes.CDLL(str(path))
        lib = _loaded[name]
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card ``index`` (what the host plans size their grids by)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def build_logs() -> Dict[str, str]:
    """``nvcc`` output (with ``-Xptxas -v`` register and spill counts) of the
    sources this process compiled."""
    return dict(_logs)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """What every kernel wrapper checks before it passes a pointer: the
    device, float32, the shape and contiguity; raises otherwise."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
