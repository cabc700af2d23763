"""Native (C++) host components, loaded through ctypes — the port's copy of
the JAX package's `_native/`.

The consistency testers' backtracking search (serialize.cpp) is the host
hot spot of semantics-checked models, so it runs natively: a plain C ABI,
compiled with `g++` at first use into the package's `_build/` directory
(the nvcc build's directory), keyed by a hash of the source and the flags.
The compiled CPU baseline checker (baseline_bfs.cpp, run by baseline.py)
is built the same way as a standalone executable (`build(..., exe=True)`).

Unlike the JAX package's `load`, which answers None on a failed compile so
its callers fall back to Python, this one raises with the compiler's
stderr, as the port's nvcc build does: every machine the port runs on has
`g++`, so a failed build is a fault to see, not a speed to lose.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SO_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
EXE_FLAGS = ["-std=c++17", "-O3", "-march=native", "-pthread"]
BUILD_TIMEOUT_S = 300.0
_lock = threading.Lock()
_cache: dict = {}


def build(name: str, *, exe: bool = False) -> Path:
    """Compile `<name>.cpp` into `_build/` (once per source and flags hash)
    and return the artifact's path: a shared object for ctypes, or with
    `exe=True` a standalone optimised executable (the CPU baseline
    checker). The two forms of one name never share a path (the flags
    enter the hash, and the shared object ends in `.so`). A failed or
    missing compiler raises RuntimeError with its output."""
    flags = EXE_FLAGS if exe else SO_FLAGS
    src = _DIR / f"{name}.cpp"
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / (f"{name}_{tag}" if exe else f"{name}_{tag}.so")
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # A per-process temporary name, so that concurrent compiles (test workers
    # starting at once) cannot interleave their output; os.replace publishes
    # the finished artifact atomically.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        try:
            proc = subprocess.run(
                ["g++", *flags, "-o", str(tmp), str(src)],
                capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ could not build {src.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load(name: str) -> ctypes.CDLL:
    """ctypes.CDLL for `<name>.cpp`, compiled on first use; raises when the
    build fails."""
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _cache[name] = lib
        return lib
