"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel file under ``csrc/`` exposes a plain C entry point, so it builds
in seconds with no PyTorch headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -lineinfo -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <sources>

``-lineinfo`` leaves the code as it is and lets ``nvdisasm -gi`` name each
SASS instruction's source line (``chip_smoke.py``'s per-part split).

The library lands in ``build/kernels/`` at the repository root, named by a
hash of the sources, of every ``csrc/`` header they include (directly or
through one another: ``include_closure``) and of the flags, so an unchanged
source is built once per checkout and an edited header rebuilds every
library that reaches it. Nothing here runs at import time; the first launch builds. A build
that fails raises with nvcc's own error output. Libraries of different names
may build at once from several threads (one nvcc each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCKS_GUARD = threading.Lock()
_LOCKS: dict[str, threading.Lock] = {}  # one per library name
_LOADED: dict[str, "BuiltLibrary"] = {}


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc's output (register and spill counts from -Xptxas -v)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def include_closure(sources: tuple[str, ...], csrc: Path = CSRC) -> tuple[str, ...]:
    """The ``csrc/`` files that ``sources`` include, directly or through one
    another (the quoted ``#include`` lines; system headers are not hashed),
    sorted."""
    seen: set[str] = set()
    todo = list(sources)
    while todo:
        for name in _INCLUDE.findall((csrc / todo.pop()).read_text()):
            if name not in seen and name not in sources and (csrc / name).is_file():
                seen.add(name)
                todo.append(name)
    return tuple(sorted(seen))


def library_path(name: str, sources: tuple[str, ...], csrc: Path = CSRC) -> Path:
    """Where ``load_library`` keeps library ``name``: ``build/kernels/`` named
    by a hash of the sources, their include closure and the flags."""
    digest = hashlib.sha256()
    for f in (*sources, *include_closure(sources, csrc)):
        digest.update(f.encode())
        digest.update((csrc / f).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str, sources: tuple[str, ...]) -> BuiltLibrary:
    """Build (once per content hash, ``library_path``) and load
    ``csrc/<sources>`` as ``name``."""
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        cached = _LOADED.get(name)
        if cached is not None:
            return cached
        paths = [CSRC / s for s in sources]
        target = library_path(name, sources)
        seconds, log = 0.0, ""
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            start = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - start
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
            os.replace(tmp, target)
        built = BuiltLibrary(ctypes.CDLL(str(target)), target, seconds, log)
        _LOADED[name] = built
        return built
