"""Build the package's CUDA sources into plain-C shared libraries.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` on first use into
``build/repro_torch_kernels/<stem>-<sha256[:16]>.so`` at the repository
root, and loaded with ``ctypes``.  Sources include shared bodies from other
kernel families (``#include "<family>/csrc/<name>.cuh"``, resolved by
``-I kernels/``), so the hash in the file name covers the source and every
``kernels/*/csrc/*.cuh`` of the package: an edited source or header is
rebuilt, an unchanged one is loaded as built.  Missing libraries are built
in parallel, one ``nvcc`` per source, each logging to ``<library>.log``
(``-Xptxas -v``: registers, shared memory, spills; then the wall and CPU
seconds the nvcc took, ``nvcc_seconds`` and ``nvcc_cpu_seconds``: with
more sources than cores the build's time is their CPU seconds over the
cores, not its longest source's).  A missing ``nvcc`` or
a failed build raises; nothing is skipped.

The sources include no PyTorch header (each exposes ``extern "C"``
launchers taking raw pointers and the stream), which keeps a build to
seconds; ``torch.utils.cpp_extension`` is deliberately not used.  The
wrappers share the launch checks below.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_KERNELS))

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Every CUDA source of the package, by stem."""
    return {p.stem: p for p in sorted(_KERNELS.glob("*/csrc/*.cu"))}


def headers() -> List[Path]:
    """Every shared CUDA header of the package."""
    return sorted(_KERNELS.glob("*/csrc/*.cuh"))


def nvcc_path() -> str:
    """The nvcc on PATH."""
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found on PATH; the CUDA kernels cannot "
                           "be built")
    return found


def library_path(src: Path, hdrs: Iterable[Path]) -> Path:
    """Where the library built from ``src`` with headers ``hdrs`` lives:
    the name carries a hash of the source and of every header (name and
    bytes), so a change to any of them names a new library."""
    h = hashlib.sha256(src.read_bytes())
    for p in hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (where needed, in parallel) and load every source; returns
    name -> CDLL."""
    hdrs = headers()
    todo = {name: (src, library_path(src, hdrs))
            for name, src in sources().items() if name not in _loaded}
    missing = {name: v for name, v in todo.items() if not v[1].exists()}
    nvcc = nvcc_path() if missing else None
    procs = []
    t0 = time.monotonic()
    for name, (src, lib) in missing.items():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as out:
            procs.append((name, lib, tmp, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=out, stderr=subprocess.STDOUT)))
    seconds, cpu = {}, {}
    while len(seconds) < len(procs):   # each nvcc's wall and CPU time
        for name, _, _, _, proc in procs:
            if name in seconds:
                continue
            pid, status, ru = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                proc.returncode = os.waitstatus_to_exitcode(status)
                seconds[name] = time.monotonic() - t0
                cpu[name] = ru.ru_utime + ru.ru_stime
        time.sleep(0.1)
    failed = []
    for name, lib, tmp, log, proc in procs:
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode})"
                          f":\n{log.read_text()}")
        else:
            with open(log, "a") as out:
                out.write(f"nvcc_seconds {seconds[name]:.1f}\n"
                          f"nvcc_cpu_seconds {cpu[name]:.1f}\n")
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, (_, lib) in todo.items():
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


def build_log(name: str) -> str:
    """The nvcc output of the library built from ``<name>.cu``."""
    log = library_path(sources()[name], headers()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check_cuda(*tensors: torch.Tensor, aligned: bool = True) -> None:
    """A CUDA kernel's inputs: CUDA tensors, 16-byte aligned unless
    ``aligned`` is False (a kernel with a path for unaligned rows)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got one "
                             f"on {t.device}")
        if aligned and t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned tensors")


def raise_on(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and synchronising would not report it)."""
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
