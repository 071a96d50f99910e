"""Local native-code build helper.

The control-plane tools (nemesis_time.py, faultfs.py) compile C++ on
the *remote node* — the reference's build-on-node discipline
(jepsen/src/jepsen/nemesis/time.clj:14-52). This module is the *local*
analog for host-side native components (the FUSE fault filesystem; the
port's C++ WGL oracle builds through checker/_build.py): compile once into a content-addressed cache under
``build/jepsen_tpu_torch/native/`` at the repository root (git-ignored)
and reuse across processes/rounds.

Returns None rather than raising when no toolchain is available, so
every native component degrades to its pure-Python fallback.

The port's copy of jepsen_tpu.utils.cc, but for its cache directory;
tests/test_torch_imports.py pins that departure.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import List, Optional

#: the port's own cache, beside its kernels' builds (checker/_build.py),
#: never the JAX package's ``~/.cache/jepsen_tpu/native``: the two
#: packages share no build state
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "build", "jepsen_tpu_torch", "native",
)


def build_shared(
    src_path: str,
    name: str,
    extra_flags: Optional[List[str]] = None,
    cache_dir: Optional[str] = None,
) -> Optional[str]:
    """Compile ``src_path`` to a shared library, content-addressed by
    source + flags. Returns the .so path, or None when g++ is missing
    or the compile fails (callers fall back to Python)."""
    return _build(
        src_path, name, ["-shared", "-fPIC", *(extra_flags or [])],
        ".so", cache_dir,
    )


def build_exe(
    src_path: str,
    name: str,
    extra_flags: Optional[List[str]] = None,
    cache_dir: Optional[str] = None,
) -> Optional[str]:
    """Compile ``src_path`` to an executable (same cache discipline)."""
    return _build(src_path, name, list(extra_flags or []), "", cache_dir)


def _build(
    src_path: str,
    name: str,
    flags: List[str],
    suffix: str,
    cache_dir: Optional[str] = None,
) -> Optional[str]:
    extra_flags = flags
    try:
        with open(src_path, "rb") as fh:
            src = fh.read()
    except OSError:
        return None
    tag = hashlib.sha256(
        src + "\0".join(extra_flags).encode()
    ).hexdigest()[:16]
    out_dir = cache_dir or CACHE_DIR
    out = os.path.join(out_dir, f"{name}-{tag}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    # Build into a temp file then rename: concurrent builders (test
    # workers) race benignly — rename is atomic on the same filesystem.
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=suffix or ".bin")
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++17",
        "-o", tmp, src_path, *extra_flags,
    ]
    os.chmod(tmp, 0o755)
    try:
        p = subprocess.run(
            cmd, capture_output=True, text=True, timeout=240
        )
    except (OSError, subprocess.TimeoutExpired):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    if p.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, out)
    return out
