"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and is compiled by nvcc into its
own shared library at first use, named by a content hash of the source
and the flags, under build/jepsen_tpu_torch/ at the repository root
(listed in .gitignore), then loaded with ctypes. Nothing is built when
a module is imported: the CPU tests import every module, and the CPU
has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

_SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "jepsen_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the kernels this package builds, one source each, with the argument
#: types of its `<name>_launch` C function (pointers, ints, the stream;
#: it returns a cudaError_t as int)
KERNELS = {
    "bitset_scan": [_P] * 5 + [_I] * 9 + [_P],
    "kfrontier_scan": [_P] * 3 + [_I] * 6 + [_P],
}

#: name -> its loaded launch function
_libs: Dict[str, Callable[..., int]] = {}
_lock = threading.Lock()
#: per-kernel nvcc report of the last build in this process:
#: {"seconds": float, "ptxas": str} (registers, shared memory, spills)
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA host")


def library_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no library for its current
    source yet, one nvcc process per source, all started together.
    Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, so, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {
            "seconds": time.perf_counter() - t0, "ptxas": log,
        }
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return BUILD_LOG


def load(name: str):
    """The `<name>_launch` function of kernel `name`, its signature
    declared; the library is built on first use."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            so = library_path(name)
            if not so.exists():
                build_all([name])
            fn = getattr(ctypes.CDLL(str(so)), f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = KERNELS[name]
            _libs[name] = fn
        return fn


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
