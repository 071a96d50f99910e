"""Build and load the hand-written CUDA kernels (csrc/*.cu) and the
host C++ libraries (csrc/*.cc).

Each source has a plain C interface and is compiled into its own shared
library at first use, named by a content hash of the source and the
flags, under build/jepsen_tpu_torch/ at the repository root (listed in
.gitignore), then loaded with ctypes: the kernels by nvcc, the host
libraries (the native oracle and prep) by g++. Nothing is built when a
module is imported: the CPU tests import every module, and the CPU has
no nvcc.
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
from typing import Callable, Dict, Iterable, Optional

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
    "bitset_scan": [_P] * 5 + [_I] * 10 + [_P],
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
    raise BuildError("nvcc not found: the CUDA kernels build on a CUDA host")


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
        raise BuildError("\n".join(failed))
    return BUILD_LOG


def load(name: str):
    """The `<name>_launch` function of kernel `name`, its signature
    declared; the library is built on first use."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            so = library_path(name)
            if not so.exists():
                # planelint: disable=JT403 reason=the build lock is held across nvcc on purpose: a second caller of the same kernel waits for its library instead of building it twice, and no launch can proceed without it
                build_all([name])
            fn = getattr(ctypes.CDLL(str(so)), f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = KERNELS[name]
            _libs[name] = fn
        return fn


class BuildError(RuntimeError):
    """A kernel that could not be built (no nvcc, or nvcc failed). Not
    a device fault: chaos.classify_fault gives it the kind "error",
    which the dispatch plane re-raises instead of retrying or
    degrading."""


class CudaError(RuntimeError):
    """A launch function's nonzero cudaError_t; ``cuda_error`` holds the
    code, which chaos.classify_fault reads (2, cudaErrorMemoryAllocation,
    is oom; the sticky codes such as 700 and 719 are fatal)."""

    def __init__(self, name: str, err: int):
        super().__init__(f"{name} launch failed: cudaError_t {err}")
        self.cuda_error = err


def check(err: int, name: str) -> None:
    """Raise CudaError on a nonzero cudaError_t returned by a launch
    function."""
    if err != 0:
        raise CudaError(name, err)


#: g++ flags of the host libraries
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

#: name -> its built host library, or None when the build failed
_native: Dict[str, Optional[Path]] = {}


def native_library(name: str) -> Optional[Path]:
    """The shared library of the host source csrc/<name>.cc, built with
    g++ at first use (content-addressed like the kernels), or None when
    there is no g++ or the build fails: callers then take their Python
    path, as the reference's do. Concurrent builds (test workers)
    each write a temporary file and rename it into place."""
    with _lock:
        if name in _native:
            return _native[name]
        src_path = _SRC_DIR / f"{name}.cc"
        digest = hashlib.sha256(
            src_path.read_bytes() + " ".join(GXX_FLAGS).encode()
        ).hexdigest()
        so = BUILD_DIR / f"{name}-{digest[:16]}.so"
        if not so.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                _native[name] = None
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            try:
                # planelint: disable=JT207 reason=the build lock is held across g++ on purpose: a second caller waits for the host library instead of building it twice, and the oracle cannot load without it
                proc = subprocess.run(
                    [gxx, *GXX_FLAGS, "-o", str(tmp), str(src_path)],
                    capture_output=True, text=True, timeout=240,
                )
            except (OSError, subprocess.TimeoutExpired):
                proc = None
            if proc is None or proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                _native[name] = None
                return None
            os.replace(tmp, so)
        _native[name] = so
        return so
