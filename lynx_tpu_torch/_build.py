"""Build and load the package's CUDA kernels.

Each kernel is CUDA C++ under ``lynx_tpu_torch/csrc/`` with a plain C entry
point.  It is compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use into
``build/lynx_tpu_torch/`` beside the package, keyed by a hash of its sources
and flags, and loaded with ``ctypes``: no PyTorch headers are compiled, so a
build takes seconds.  ``--use_fast_math`` is deliberately absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lynx_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBRARIES: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Load ``lib<name>.so`` built from ``csrc/<name>.cu`` (and the shared
    ``csrc/*.cuh`` headers), building it first if no build of these exact
    sources exists.

    ``signatures`` maps each C entry point to ``(restype, argtypes)``; they
    are declared once, at load.  Undeclared, ctypes would pass a pointer as
    a 32-bit int and cut it."""
    if name in _LIBRARIES:
        return _LIBRARIES[name]
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in sources:
        digest.update(source.read_bytes())
    target = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(sources[0])]
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}:\n{' '.join(command)}\n{result.stderr}"
            )
        os.replace(partial, target)  # atomic: a concurrent build never sees half a file
    library = ctypes.CDLL(str(target))
    signatures = {"lynx_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]), **signatures}
    for function, (restype, argtypes) in signatures.items():
        getattr(library, function).restype = restype
        getattr(library, function).argtypes = argtypes
    _LIBRARIES[name] = library
    return library


def check(library: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code (every
    kernel library exports ``lynx_cuda_error_string``)."""
    if code != 0:
        message = library.lynx_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")
