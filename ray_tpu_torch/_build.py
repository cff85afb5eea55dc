"""Builds the port's CUDA sources at first use and loads them with ctypes.

Every `ops/csrc/*.cu` compiles with nvcc for sm_90a into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to `ray_tpu_torch/_build/<hash>/`, where the hash
covers every source and header in `csrc/` and the flags, so an edited
source builds anew. All sources compile in parallel, one nvcc each. A
missing nvcc or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "ops" / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log = ""  # nvcc's output (ptxas register and shared-memory use)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: ray_tpu_torch builds its CUDA kernels at first use "
        "and needs the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source not yet built; returns {stem: library path}."""
    global build_log
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    errors, logs = [], []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs.append(f"== {src.name}\n{log}")
        if proc.returncode:
            errors.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    build_log = "\n".join(logs)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {p.stem[3:]: p for p in out.glob("lib*.so")}


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return lib
