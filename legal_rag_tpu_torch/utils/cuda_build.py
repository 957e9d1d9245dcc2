"""Build the port's native code into shared libraries, and launch its
hand-written CUDA kernels.

:func:`build_shared_library` compiles every native library of the port:
each kernel source under ``legal_rag_tpu_torch/csrc/`` (a plain C entry
point, compiled by ``nvcc`` alone, no PyTorch headers, so a build takes
seconds) into ``build/torch_kernels/<name>-<hash>/``, and the host
library of ``native_ext.py`` (g++) into ``build/torch_native/``. Each is
keyed by a hash of its sources, the headers they include and the
compiler flags, so an edited file rebuilds and an unchanged one is
reused, and each is loaded with :mod:`ctypes`. :class:`CudaKernel`
holds one built kernel library, its entry points' ctypes signatures,
its launch (:meth:`CudaKernel.launch`) and its counts of launches,
direct and inside CUDA-graph replays (``utils/graphs.py``);
:data:`KERNELS` lists every one.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

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

# one limit for every compile, nvcc's and g++'s: over six times the
# slowest build, K3's 34 kernels (93 s on the H100 machine's host while
# the other six kernels compile beside it; the host library takes 4 s)
COMPILE_TIMEOUT_S = 600

_locks: Dict[str, threading.Lock] = {}
# every kernel library object, in creation order (each ops module makes
# its own at import): a captured program reads their counters
KERNELS: List["CudaKernel"] = []
_locks_guard = threading.Lock()


def _lock_for(name: str) -> threading.Lock:
    """One lock per library, so that different libraries build at once."""
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


def library_path(name: str, files: Sequence[Path], flags: Sequence[str],
                 build_dir: Path) -> Path:
    """``build_dir/<name>-<hash>/lib<name>.so``, the hash over the bytes
    of ``files`` in order and the flags."""
    h = hashlib.sha256()
    for f in files:
        h.update(Path(f).read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_shared_library(
    name: str, sources: Sequence[Path], *, hashed: Sequence[Path],
    compiler: Callable[[], str], flags: Sequence[str], build_dir: Path,
    log: str, force: bool = False,
) -> Tuple[Path, str]:
    """Compile ``sources`` with ``compiler()`` (its path; it raises
    ``RuntimeError`` if there is none) and ``flags`` into
    :func:`library_path`'s ``lib<name>.so``, keyed by the sources, the
    files ``hashed`` (their headers) and the flags; a built one is
    reused unless ``force``. One build of a library at a time, across
    threads and processes. Returns the path and the compiler's log, kept
    beside the library as ``log`` (a failed build's too). Raises
    ``RuntimeError`` with the compiler's stderr on failure or past
    ``COMPILE_TIMEOUT_S``."""
    lib = library_path(name, [*sources, *hashed], flags, build_dir)
    out_dir = lib.parent
    log_path = out_dir / log
    with _lock_for(name):
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as held:
            fcntl.flock(held, fcntl.LOCK_EX)     # another process's build
            if lib.is_file() and not force:
                return lib, (log_path.read_text() if log_path.is_file()
                             else "")
            # build under a private name, then rename into place: a
            # concurrent process never loads a half-written library
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [compiler(), *flags, "-o", str(tmp), *map(str, sources)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=COMPILE_TIMEOUT_S)
                status, stderr = f"exit {proc.returncode}", proc.stderr
            except (subprocess.SubprocessError, OSError) as e:
                status, stderr = "did not run to an end", str(e)
            text = f"{' '.join(cmd)}\n{status}\n{stderr}"
            log_path.write_text(text)
            if status != "exit 0":
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{Path(cmd[0]).name} {status} building {name}:\n{text}")
            os.replace(tmp, lib)
            return lib, text


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, read
    without building a ``torch.cuda.Stream`` (0.10 us a call against 5.42
    us for ``torch.cuda.current_stream(device).cuda_stream``, NVIDIA H100
    80GB HBM3; ``scripts/launch_steps.py``)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's multiprocessor count, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class CudaKernel:
    """One kernel library built from ``csrc/<source>``: ``library()``
    builds and loads it on first use (under a lock; afterwards it is a
    plain attribute read) and declares each entry point's ctypes
    signature once (every one returns the CUDA error as an ``int``);
    :meth:`launch` calls an entry point, raises on its CUDA error and
    counts the launch through ``count_launch()``, a plain increment
    (``launches``); ``build_log`` keeps nvcc's report. Each entry point makes the tensor's device current only
    when it is not, and sets its kernels' attributes once per device
    (``csrc/setup.cuh``).

    A wrapper called while a CUDA graph is captured records a launch
    instead of making one: the captured program takes that count back
    (:meth:`uncount`) and adds it to ``in_replays`` at every replay
    (:meth:`count_replays`), one entry per name in ``COUNTERS``."""

    COUNTERS: Tuple[str, ...] = ("launches",)

    def __init__(self, name: str, source: str,
                 signatures: Dict[str, Sequence[type]]) -> None:
        self.name = name
        self.source = source
        self.signatures = signatures
        self.launches = 0
        self.in_replays = dict.fromkeys(self.COUNTERS, 0)
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        KERNELS.append(self)

    def library(self) -> ctypes.CDLL:
        lib = self._lib
        return lib if lib is not None else self._load()

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, self.build_log = build_shared_library(
                    self.name, [CSRC_DIR / self.source],
                    hashed=sorted(CSRC_DIR.glob("*.cuh")),
                    compiler=find_nvcc, flags=NVCC_FLAGS,
                    build_dir=BUILD_DIR, log="nvcc.log")
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in self.signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def launch(self, entry: str, *args, **counts) -> None:
        """Call entry point ``entry`` with ``args``; raise
        ``RuntimeError`` if it returns a CUDA error, else count the
        launch (``count_launch(**counts)``)."""
        err = getattr(self.library(), entry)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err}")
        self.count_launch(**counts)

    def count_launch(self) -> None:
        self.launches += 1

    def counts(self) -> Dict[str, int]:
        """The direct launch counters, by name."""
        return {name: getattr(self, name) for name in self.COUNTERS}

    def uncount(self, delta: Dict[str, int]) -> None:
        """Take back counts that a capture recorded, not launched."""
        for name, n in delta.items():
            setattr(self, name, getattr(self, name) - n)

    def count_replays(self, delta: Dict[str, int]) -> None:
        """One replay of a program that captured ``delta`` launches."""
        for name, n in delta.items():
            self.in_replays[name] += n

    def reset_counts(self) -> None:
        """Every counter, direct and in replays, back to 0."""
        for name in self.COUNTERS:
            setattr(self, name, 0)
            self.in_replays[name] = 0
