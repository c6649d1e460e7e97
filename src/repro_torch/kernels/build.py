"""Build the port's CUDA sources (``repro_torch/csrc/*.cu``) with ``nvcc``
into shared libraries with a plain C interface, loaded with ``ctypes``.

Each source becomes its own library under the git-ignored
``build/repro_torch/`` of the checkout, named by a hash of every file in
``csrc/`` and of the flags, so an edited source rebuilds and an unchanged
one is reused. Nothing is built at import: the first call that launches a
kernel builds it (or ``build(name)`` builds it ahead).

``COMPILES`` counts, per library, the ``build`` calls that ran ``nvcc``
(the port's compile event) and ``LOADS`` the libraries loaded with
``ctypes``; ``repro_torch.analysis.guard.recompile_guard`` reads them.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

# nvcc runs and ctypes loads per library, since the process started
COMPILES: Dict[str, int] = {}
LOADS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()


def _count(counter: Dict[str, int], name: str) -> None:
    with _COUNT_LOCK:
        counter[name] = counter.get(name, 0) + 1


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was reused
    log: str            # nvcc/ptxas output (registers, spills)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> BuildResult:
    """Build ``csrc/<name>.cu`` unless a library for the current sources
    exists. Raises ``RuntimeError`` with the compiler's output on failure."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out = BUILD_DIR / f"lib{name}-{_digest()}.so"
    log = Path(f"{out}.log")
    if out.exists():
        return BuildResult(name, out, 0.0,
                           log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    _count(COMPILES, name)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, out)
    return BuildResult(name, out, secs, text)


def build_all(names: Sequence[str]) -> List[BuildResult]:
    """Build several sources at once, one ``nvcc`` process each."""
    with concurrent.futures.ThreadPoolExecutor(len(names) or 1) as pool:
        return list(pool.map(build, names))


_LIBS: Dict[str, ctypes.CDLL] = {}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name).path))
        _count(LOADS, name)
    return _LIBS[name]
