"""ctypes binding of the C++ WordPiece tokenizer (host code, no card).

The counterpart of ``legal_rag_tpu/native_ext.py``: ``NativeWordPiece``
(the Python tokenizer's contract, ``models/wordpiece.py``),
``native_available`` and ``build_native``. The source is the port's own
copy, ``legal_rag_tpu_torch/native/`` (``wordpiece.cpp``,
``unicode_tables.h`` and the tables' generator, verbatim copies of the
JAX package's). ``g++ -O2 -std=c++17 -fPIC -shared`` compiles it on
first use, never at import, into ``build/torch_native/wordpiece-<hash>/``
at the repository root, keyed by a hash of the sources and the flags, as
``utils/cuda_build.py`` builds the kernels: under a lock (threads and
processes), under a private name and then renamed into place, with the
compiler's log kept beside it, on failure too. Where nothing builds it,
every caller tokenizes in Python, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
SOURCES = ("wordpiece.cpp", "unicode_tables.h")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current sources and flags lands."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"wordpiece-{h.hexdigest()[:16]}" / "libwordpiece.so"


def build_native(force: bool = False) -> bool:
    """Compile the library (or find it built); True on success. The
    compiler's output lands in ``g++.log`` beside the library."""
    lib = library_path()
    out_dir = lib.parent
    with _lock:
        if lib.is_file() and not force:
            return True
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            return False
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as held:
            fcntl.flock(held, fcntl.LOCK_EX)     # another process's build
            if lib.is_file() and not force:
                return True
            tmp = out_dir / f".libwordpiece.{os.getpid()}.so"
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
                   str(NATIVE_DIR / "wordpiece.cpp")]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except (subprocess.SubprocessError, OSError) as e:
                (out_dir / "g++.log").write_text(f"{' '.join(cmd)}\n{e}\n")
                return False
            (out_dir / "g++.log").write_text(
                f"{' '.join(cmd)}\nexit {proc.returncode}\n{proc.stderr}")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                return False
            os.replace(tmp, lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not build_native():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:
        return None
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode.restype = ctypes.c_int32
    lib.wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    _lib = lib
    return _lib


class NativeWordPiece:
    """C++ WordPiece encoder with the Python tokenizer's contract."""

    def __init__(self, vocab: Dict[str, int]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native wordpiece library unavailable")
        self._lib = lib
        self.vocab = vocab
        inv = {i: t for t, i in vocab.items()}
        tokens = [inv[i].encode("utf-8") for i in range(len(inv))]
        arr = (ctypes.c_char_p * len(tokens))(*tokens)
        from legal_rag_tpu_torch.models.wordpiece import PAD, UNK, CLS, SEP

        self.pad_id = vocab[PAD]
        self._handle = lib.wp_create(
            arr, len(tokens),
            vocab[UNK], vocab[CLS], vocab[SEP], vocab[PAD],
        )

    def __del__(self):  # noqa: D105
        handle = getattr(self, "_handle", None)
        if handle and self._lib:
            self._lib.wp_destroy(handle)
            self._handle = None

    def encode(
        self, text: str, max_len: int = 256, add_special: bool = True
    ) -> List[int]:
        # ctypes drops the GIL during the call, and the server encodes
        # from several threads at once: each call writes its own buffer
        # (at most max_len ids, or [CLS] [SEP] when max_len < 2).
        data = text.encode("utf-8")
        buf = np.empty(max(max_len, 0) + 2, dtype=np.int32)
        n = self._lib.wp_encode(
            self._handle, data, len(data),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(buf), int(add_special), max_len,
        )
        return buf[:n].tolist()

    def encode_batch(self, texts: Sequence[str], max_len: int = 256):
        """Same bucketing contract as WordPieceTokenizer.encode_batch
        (shared helper — shapes must never diverge between paths)."""
        from legal_rag_tpu_torch.models.wordpiece import pad_and_bucket

        encoded = [self.encode(t, max_len=max_len) for t in texts]
        return pad_and_bucket(encoded, max_len, self.pad_id)


def native_available() -> bool:
    return _load() is not None
