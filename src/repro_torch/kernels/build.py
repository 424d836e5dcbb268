"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled on first use by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/repro_torch_kernels/`` at the checkout's root (listed
in ``.gitignore``), named by a hash of the sources and flags, then loaded
with ``ctypes``.  Several sources build in parallel, one ``nvcc`` each.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the port's "
            f"CUDA kernels are built from source on the machine with the card")
    return found


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every kernel in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns per name ``{"seconds", "log"}``
    (``log`` holds ptxas' register and spill report; 0 s and an empty log
    for a library that was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _LIBS[name] = lib
    return lib
