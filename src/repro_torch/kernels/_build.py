"""Build the hand-written CUDA kernels with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (the hash covers the source, the headers it
includes from ``csrc/`` and the flags, so an edited source or header
rebuilds).  Builds happen on first use, never at import;
:func:`build_all` starts one ``nvcc`` per source at once.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built from source on first use")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(src: Path) -> list[Path]:
    """``src`` and every file it includes by a quoted ``#include`` that
    lies beside it (the shared headers under ``csrc/``), transitively, in
    the order first met."""
    found, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [p for p in (path.parent / m.decode()
                             for m in _INCLUDE.findall(path.read_bytes()))
                 if p.is_file()]
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in sources(src):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name`` unless it is built; returns (proc, tmp, so)."""
    src, so = _target(name)
    if so.exists():
        return None, None, so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(proc, tmp, so: Path) -> tuple[int, str]:
    """Wait for one compile; install the library when it succeeded."""
    if proc is None:
        return 0, ""
    log, _ = proc.communicate()
    if proc.returncode == 0:
        os.replace(tmp, so)
    else:
        os.unlink(tmp)
    return proc.returncode, log


def build_all(names: list[str]) -> dict[str, str]:
    """Compile every named source in parallel (one nvcc each), wait for all
    of them, and load the libraries; returns each compiler log (empty when
    already built).  Raises if any compile failed."""
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        done = {n: _finish(*job) for n, job in started.items()}
        failed = {n: r for n, r in done.items() if r[0] != 0}
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}.cu (exit {rc})\n{log}"
                for n, (rc, log) in failed.items()))
        for n, (_, _, so) in started.items():
            _LIBS[n] = ctypes.CDLL(str(so))
    return {n: log for n, (_, log) in done.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]
