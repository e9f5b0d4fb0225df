"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with
a plain C interface and loaded with `ctypes`. The library is built at first
use into `reid_tpu_torch/_build/`, named by a hash of the sources it
includes, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built while a module is imported.

Every kernel wrapper adds one to its launch count where it launches its
kernel and nowhere else, so a run can show which kernels its path went
through (`reset_launch_counts` / `launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_SITE_COUNTS: Dict[Tuple[str, Tuple[int, ...]], int] = {}


def count_launch(name: str, site: Tuple[int, ...] = ()) -> None:
    """One launch of kernel `name`; `site` is the per-image shape of the
    call, which tells the call sites of one kernel apart."""
    _SITE_COUNTS[(name, site)] = _SITE_COUNTS.get((name, site), 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches by kernel name, all call sites together."""
    counts: Dict[str, int] = {}
    for (name, _), n in _SITE_COUNTS.items():
        counts[name] = counts.get(name, 0) + n
    return counts


def site_launch_counts() -> Dict[Tuple[str, Tuple[int, ...]], int]:
    return dict(_SITE_COUNTS)


def reset_launch_counts() -> None:
    _SITE_COUNTS.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources(name: str) -> List[str]:
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, name + ".cu")] + [
        os.path.join(CSRC, h) for h in headers]


def lib_path(name: str) -> str:
    digest = hashlib.sha256()
    for src in _sources(name):
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _tmp(out: str) -> str:
    # one scratch name per process, so concurrent builds never share it
    return f"{out}.{os.getpid()}.tmp"


def _start_build(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = lib_path(name)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", _tmp(out),
           os.path.join(CSRC, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    out = lib_path(name)
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(_tmp(out), out)
    return log


def build(names: Iterable[str]) -> dict:
    """Build the named libraries that are missing, one `nvcc` per source,
    all started together. Returns the names built and the wall seconds."""
    names = [n for n in names if not os.path.exists(lib_path(n))]
    t0 = time.perf_counter()
    procs = {n: _start_build(n) for n in names}
    for n, proc in procs.items():
        _finish_build(n, proc)
    return {"built": names, "seconds": time.perf_counter() - t0}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
