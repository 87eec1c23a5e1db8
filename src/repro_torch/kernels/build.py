"""Build the package's CUDA sources into plain-C shared libraries.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` on first use into
``build/repro_torch_kernels/<stem>-<sha256[:16]>.so`` at the repository
root, and loaded with ``ctypes``.  The source hash is in the file name, so
an edited source is rebuilt and an unchanged one is loaded as built.  A
missing ``nvcc`` or a failed build raises; nothing is skipped.

The sources include no PyTorch header (each exposes an ``extern "C"``
launcher taking raw pointers and the stream), which keeps a build to
seconds; ``torch.utils.cpp_extension`` is deliberately not used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every CUDA source of the package, by stem."""
    return {p.stem: p for p in sorted(_KERNELS.glob("*/csrc/*.cu"))}


def nvcc_path() -> str:
    """The nvcc on PATH."""
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found on PATH; the CUDA kernels cannot "
                           "be built")
    return found


def _library(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load every source; returns name -> CDLL."""
    for name, src in sources().items():
        if name in _loaded:
            continue
        lib = _library(src)
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} (exit "
                                   f"{proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, lib)
        _loaded[name] = ctypes.CDLL(str(lib))
    return dict(_loaded)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``<name>.cu`` (built on first use)."""
    if name not in _loaded:
        build_all()
    if name not in _loaded:
        raise KeyError(f"no CUDA source named {name!r}; have "
                       f"{sorted(sources())}")
    return _loaded[name]
