"""ctypes binding of the C++ WordPiece tokenizer and the BM25 postings
gather (host code, no card).

The counterpart of ``legal_rag_tpu/native_ext.py``: ``NativeWordPiece``
(the Python tokenizer's contract, ``models/wordpiece.py``),
``native_available`` and ``build_native``; and the port's own
``gather_postings``. The source is the port's own copy,
``legal_rag_tpu_torch/native/`` (``wordpiece.cpp``, ``unicode_tables.h``
and the tables' generator, verbatim copies of the JAX package's, the
port's own ``wordpiece_pairs.cpp``, the cross-encoder's pair encoding on
top of ``wp_encode``, and ``postings_gather.cpp``, a query batch's BM25
postings, each row past the budget cut by weight in the same call). ``g++ -O2 -std=c++17 -fPIC -shared`` compiles the sources
into one library on first use, never at import, into
``build/torch_native/wordpiece-<hash>/`` at the repository root, keyed
by a hash of the sources and the flags, through the builder that builds
the kernels (``utils/cuda_build.py build_shared_library``): one build at
a time across threads and processes, under a private name and then
renamed into place, with the compiler's log ``g++.log`` kept beside it,
on failure too. Where nothing builds it, every caller tokenizes and
gathers in Python, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from legal_rag_tpu_torch.utils import cuda_build

NATIVE_DIR = cuda_build.REPO_ROOT / "legal_rag_tpu_torch" / "native"
BUILD_DIR = cuda_build.REPO_ROOT / "build" / "torch_native"
COMPILED = ("wordpiece.cpp", "wordpiece_pairs.cpp", "postings_gather.cpp")
HEADERS = ("unicode_tables.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lock = threading.Lock()


def _paths(names: Sequence[str]) -> List[Path]:
    return [NATIVE_DIR / name for name in names]


def find_cxx() -> str:
    """``$CXX`` (default ``g++``) on the ``PATH``."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX or g++) on the PATH")
    return cxx


def library_path() -> Path:
    """Where the library of the current sources and flags lands."""
    return cuda_build.library_path("wordpiece", _paths(COMPILED + HEADERS),
                                   CXX_FLAGS, BUILD_DIR)


def build_native(force: bool = False) -> bool:
    """Compile the library (or find it built); True on success, False
    where no compiler is found or the build fails. The compiler's output
    lands in ``g++.log`` beside the library."""
    try:
        cuda_build.build_shared_library(
            "wordpiece", _paths(COMPILED), hashed=_paths(HEADERS),
            compiler=find_cxx, flags=CXX_FLAGS, build_dir=BUILD_DIR,
            log="g++.log", force=force)
    except (RuntimeError, OSError):
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded by the first call (other threads
    wait for it); every later call returns that call's result, None
    where it did not build or load."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    with _lock:
        if not _lib_tried:
            try:
                if build_native():
                    _lib = _declare(ctypes.CDLL(str(library_path())))
            except OSError:
                pass
            _lib_tried = True
    return _lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
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
    lib.wp_encode_pairs.restype = ctypes.c_int32
    lib.wp_encode_pairs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    ptr = ctypes.c_void_p     # numpy buffers, checked by gather_postings
    lib.bm25_gather_postings.restype = ctypes.c_int32
    lib.bm25_gather_postings.argtypes = [
        ptr, ptr, ptr, ctypes.c_int64, ptr, ptr, ptr, ctypes.c_int32,
        ctypes.c_int64, ptr, ptr, ptr, ptr, ptr,
    ]
    return lib


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

    def encode_pairs(
        self, queries: Sequence[str], docs: Sequence[str], max_len: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``CrossEncoder.encode_pairs``'s ``[B, L]`` ids, mask and
        segment ids of ``zip(queries, docs)``, in one C++ call
        (``native/wordpiece_pairs.cpp``) without the GIL; a query equal
        to the previous pair's is tokenized once."""
        if max_len < 1:
            raise ValueError(f"max_len must be positive, got {max_len}")
        texts = [t.encode("utf-8") for pair in zip(queries, docs)
                 for t in pair]
        n = len(texts) // 2
        offsets = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in texts], out=offsets[1:])
        out = np.empty((3, n * max_len), dtype=np.int32)
        ptr = ctypes.POINTER(ctypes.c_int32)
        width = self._lib.wp_encode_pairs(
            self._handle, b"".join(texts),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_len, self.pad_id,
            *(row.ctypes.data_as(ptr) for row in out),
        )
        ids, mask, tt = (row[:n * width].reshape(n, width) for row in out)
        return ids, mask, tt


def native_available() -> bool:
    return _load() is not None


def gather_postings(
    terms: np.ndarray, mult: np.ndarray, term_offsets: np.ndarray,
    indptr: np.ndarray, doc_ids: np.ndarray, weights: np.ndarray,
    n_docs: int, budget: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """A query batch's postings in one C++ call without the GIL
    (``native/postings_gather.cpp``): query ``q``'s distinct terms
    ``terms[term_offsets[q]:term_offsets[q + 1]]`` (int64) with their
    multiplicities ``mult`` (float32), over the CSR ``indptr`` (int64),
    ``doc_ids`` (int32) and ``weights`` (float32). Returns ``(ids [Q,
    budget] int32, weights [Q, budget] float32, totals [Q] int64, cut [Q]
    uint8, cut_s)``: a row whose total passes ``budget`` is cut by weight
    under ``ops.sparse.cut_by_weight``'s rule, ``cut`` is 0 for a row that
    fits, 1 for a row cut and 2 for a row cut inside a group of equal
    weights, and ``cut_s`` the seconds the call spent on the rows it cut.
    Raises ValueError if a row past the budget holds a negative or NaN
    weight, RuntimeError if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    q = len(term_offsets) - 1
    terms = np.ascontiguousarray(terms, np.int64)
    mult = np.ascontiguousarray(mult, np.float32)
    term_offsets = np.ascontiguousarray(term_offsets, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    doc_ids = np.ascontiguousarray(doc_ids, np.int32)
    weights = np.ascontiguousarray(weights, np.float32)
    if (q < 0 or len(mult) != len(terms)
            or term_offsets[0] != 0 or term_offsets[-1] != len(terms)
            or np.any(np.diff(term_offsets) < 0) or budget < 1
            or len(doc_ids) != len(weights) or indptr[-1] > len(doc_ids)):
        raise ValueError("inconsistent postings gather arguments")
    if len(terms) and (terms.min() < 0 or terms.max() >= len(indptr) - 1):
        raise ValueError("term id outside the index's vocabulary")
    out_ids = np.empty((q, budget), np.int32)
    out_w = np.empty((q, budget), np.float32)
    totals = np.empty(q, np.int64)
    cut = np.empty(q, np.uint8)
    cut_s = ctypes.c_double(0.0)
    rc = lib.bm25_gather_postings(
        terms.ctypes.data, mult.ctypes.data, term_offsets.ctypes.data, q,
        indptr.ctypes.data, doc_ids.ctypes.data, weights.ctypes.data,
        n_docs, budget, out_ids.ctypes.data, out_w.ctypes.data,
        totals.ctypes.data, cut.ctypes.data, ctypes.byref(cut_s),
    )
    if rc != 0:
        raise ValueError("a query past the budget has a negative or NaN "
                         "posting weight")
    return out_ids, out_w, totals, cut, cut_s.value
