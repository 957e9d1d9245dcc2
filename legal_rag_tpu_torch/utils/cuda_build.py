"""Build the port's hand-written CUDA kernels into shared libraries.

Each kernel source under ``legal_rag_tpu_torch/csrc/`` has a plain C
entry point and is compiled by ``nvcc`` alone (no PyTorch headers, so a
build takes seconds), then loaded with :mod:`ctypes`. Libraries land in
``build/torch_kernels/<name>-<hash>/`` at the repository root, keyed by
a hash of the source bytes, the headers beside them (``*.cuh``) and the
compiler flags, so an edited source or header rebuilds and an unchanged
one is reused. :class:`CudaKernel` holds one built library, its entry
points' ctypes signatures and its count of launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC_DIR = REPO_ROOT / "legal_rag_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"

# sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available;
# -Xptxas -v reports registers, shared memory and spills per kernel
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock_for(name: str) -> threading.Lock:
    """One lock per library, so that different kernels build at once."""
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def build_shared_library(
    name: str, sources: Sequence[Path]
) -> Tuple[Path, str]:
    """Compile ``sources`` into ``lib<name>.so``; returns the library
    path and the compiler's log (kept beside the library, so a reused
    build returns its log too). Raises ``RuntimeError`` carrying nvcc's
    stderr on failure."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    log = out_dir / "nvcc.log"
    with _lock_for(name):
        if lib.is_file():
            return lib, log.read_text() if log.is_file() else ""
        out_dir.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename into place: a
        # concurrent process never loads a half-written library
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stderr}"
            )
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
        return lib, proc.stderr


class CudaKernel:
    """One kernel library built from ``csrc/<source>``: ``library()``
    builds and loads it once (thread-safe) and declares each entry
    point's ctypes signature (every one returns the CUDA error as an
    ``int``); ``launches`` counts the launches its wrapper reports
    through ``count_launch()``; ``build_log`` keeps nvcc's report."""

    def __init__(self, name: str, source: str,
                 signatures: Dict[str, Sequence[type]]) -> None:
        self.name = name
        self.source = source
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_shared_library(
                    self.name, [CSRC_DIR / self.source]
                )
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def count_launch(self) -> None:
        with self._lock:
            self.launches += 1
