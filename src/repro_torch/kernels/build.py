"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kernels/`` at
the repository root; the library is loaded with ``ctypes``. The first use
of any kernel starts one ``nvcc`` per source, all at once, and waits for
them. A library's file name carries a hash of its source and of the
sources it includes from ``csrc`` (a ``_bf16`` source includes its fp32
source, or a header the two share, and is a unit of its own so that the two
forms' instances compile in parallel), so an edited source is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

SOURCES = ("qmatmul", "qmatmul_bf16", "flash_decode", "flash_decode_bf16",
           "flash_attention", "flash_attention_bf16", "atu_update")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per-source ptxas report (registers, shared memory, spills) of this process's builds
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _source_bytes(name: str) -> bytes:
    """``csrc/<name>`` and every ``csrc`` file it includes by a quoted
    name, in order."""
    text = (CSRC / name).read_bytes()
    out = [text]
    for line in text.decode().splitlines():
        if line.startswith('#include "'):
            out.append(_source_bytes(line.split('"')[1]))
    return b"".join(out)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(_source_bytes(f"{name}.cu")).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every source without an up-to-date library, in parallel.
    Returns the wall seconds spent (0.0 when everything was built)."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, out, proc in jobs:
        text, _ = proc.communicate()
        build_log[name] = text
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    import torch
    dev = torch.device(device)
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a kernel's C function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
