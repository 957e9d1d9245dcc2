"""The port's C++ WordPiece tokenizer (``legal_rag_tpu_torch/native``,
bound by ``legal_rag_tpu_torch.native_ext``) against the port's Python
tokenizer and the JAX package's native tokenizer: ids exactly equal on
a synthetic corpus in the five laws' shape and on the adversarial,
Unicode fuzz, truncation, no-special and ``encode_batch`` cases of
tests/test_native.py (copied here: that file's fixture reads a corpus
this image lacks). Also the encoder's tokenizer choice, where the
library is built and what it reads, how the port's one library builder
(``utils/cuda_build.py build_shared_library``) reuses, forces, locks
and fails, and a store built by the JAX package with its native
tokenizer, served by the port."""

import logging
import random
import subprocess
import sys
import unicodedata
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from legal_rag_tpu import native_ext as jax_native
from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig
from legal_rag_tpu.index.builder import build_index as jax_build
from legal_rag_tpu.index.store import VectorStore as JaxStore
from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
from legal_rag_tpu_torch import native_ext
from legal_rag_tpu_torch.index.builder import _chunk_dicts
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.encoder import SentenceEncoder
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab,
)
from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine

REPO_ROOT = Path(__file__).resolve().parent.parent
CFG = RetrievalConfig(
    encoder=EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                          intermediate=128, max_len=64, encode_batch=64),
    sharding=ShardingConfig(num_shards=1),
)
EMB_TOL = 1e-5      # fp32 MiniLM forwards in two frameworks

# tests/test_native.py's ADVERSARIAL cases
ADVERSARIAL = [
    "",
    "   ",
    "Hello, World!",
    "Café résumé naïve Łódź",
    "§183 — the 'said' provision… (a) [b] {c}",
    "word­with​format‌chars",
    "CJK 中文 mixed 漢字 text",
    "x" * 250,                      # oversize word -> UNK
    "UPPER lower MiXeD 123 45.67",
    "tabs\tand\nnewlines\r\nand  spaces",
    "em—dash–hyphen-minus",
    "धारा १७३ के अनुसार। दंड प्रक्रिया।",        # Devanagari + danda U+0964
    "İstanbul'da İĞNE ve ışık",                  # Turkish İ (1->2 cps), ı
    "ΝΟΜΟΣ ΠΟΙΝΙΚΟΣ: Ο Σ ΣΤΟ ΤΕΛΟΣ",            # Greek incl. Final_Sigma
    "ΟΔΥΣΣΕΥΣ ΟΔΥΣΣΕΥΣΑ 'ΣΟΦΟΣ' (ΣΟΦΟΣ)",       # sigma + punct contexts
    "УГОЛОВНЫЙ КОДЕКС статья",                   # Cyrillic case
    "ʼn ǅungla ǲur ﬁne ﬂow",                     # special lower/compat chars
    "áé combining, ﬀ ligature",      # standalone Mn marks
    "豈 更 車 compatibility ideographs",          # F900 block NFD-maps
    "１２３ ＡＢＣ ｆｕｌｌｗｉｄｔｈ！？",         # fullwidth forms
]


def fuzz_texts():
    """tests/test_native.py's randomized full-Unicode sweep, as texts."""
    rng = random.Random(7)
    pool = []
    while len(pool) < 600:
        ch = chr(rng.randrange(0x20, 0x2FA20))
        if unicodedata.category(ch).startswith("C"):
            continue
        pool.append(ch)
    out = []
    for _ in range(300):
        t = "".join(rng.choice(pool) for _ in range(rng.randrange(1, 30)))
        if rng.random() < 0.3:
            t = t.replace(t[rng.randrange(len(t))], "Σ")
        out.append(t)
    return out


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    docs = tmp_path_factory.mktemp("native_docs")
    write_legal_corpus(docs, n_chunks=400, seed=3)
    return _chunk_dicts(parse_corpus(docs))


@pytest.fixture(scope="module")
def trio(chunks):
    """(the port's Python, the port's C++, the JAX package's C++)
    tokenizers over one vocab, and the corpus texts."""
    if not native_ext.build_native():
        pytest.skip("no C++ compiler builds the native tokenizer")
    texts = [c["text"] for c in chunks]
    vocab = build_wordpiece_vocab(texts, size=8000, min_freq=1)
    return (WordPieceTokenizer(vocab), native_ext.NativeWordPiece(vocab),
            jax_native.NativeWordPiece(vocab), texts)


def _assert_same(trio, text, **kw):
    py, cc, jcc, _ = trio
    want = py.encode(text, **kw)
    assert cc.encode(text, **kw) == want, repr(text[:80])
    assert jcc.encode(text, **kw) == want, repr(text[:80])


def test_corpus_parity(trio):
    for t in trio[3]:
        _assert_same(trio, t, max_len=256)


@pytest.mark.parametrize("case", ["adversarial", "fuzz"])
def test_unicode_parity(trio, case):
    for t in ADVERSARIAL if case == "adversarial" else fuzz_texts():
        _assert_same(trio, t, max_len=64)


def test_truncation_and_no_special(trio):
    long_text = " ".join(trio[3][:5])
    _assert_same(trio, long_text, max_len=32)
    _assert_same(trio, long_text, max_len=32, add_special=False)


def test_concurrent_encode_parity(trio):
    """The server encodes queries from many threads at once, and the C++
    call runs without the GIL: no call may see another's ids."""
    py, cc, _, texts = trio
    work = [texts[i % len(texts)] for i in range(16 * 40)]
    want = [py.encode(t, max_len=128) for t in work]
    with ThreadPoolExecutor(max_workers=16) as pool:
        got = list(pool.map(lambda t: cc.encode(t, max_len=128), work))
    assert got == want


def test_encode_batch_parity(trio):
    py, cc, jcc, texts = trio
    ids_p, mask_p = py.encode_batch(texts[:16], max_len=128)
    for tok in (cc, jcc):
        ids, mask = tok.encode_batch(texts[:16], max_len=128)
        np.testing.assert_array_equal(ids, ids_p)
        np.testing.assert_array_equal(mask, mask_p)


@pytest.mark.parametrize("prefer,native,want", [
    ("auto", True, "native-cpp"), ("native-cpp", True, "native-cpp"),
    ("python", True, "python"), ("auto", False, "python"),
    ("native-cpp", False, "python"),
])
def test_encoder_tokenizer_choice(trio, monkeypatch, caplog, prefer, native,
                                  want):
    """The JAX constructor's semantics: ``auto`` and ``native-cpp`` take
    the C++ tokenizer where it builds, ``native-cpp`` warns where it
    does not, ``python`` never takes it; ``tokenizer_impl`` says which,
    and ``tokenize`` uses it."""
    if not native:
        monkeypatch.setattr(native_ext, "native_available", lambda: False)
    py = trio[0]
    cfg = EncoderConfig(vocab_size=len(py.vocab), hidden=32, layers=1,
                        heads=2, intermediate=64, max_len=64)
    with caplog.at_level(logging.WARNING):
        enc = SentenceEncoder(cfg=cfg, tokenizer=py, prefer_tokenizer=prefer,
                              device="cpu")
    assert enc.tokenizer_impl == want
    assert isinstance(enc.fast_tokenizer, native_ext.NativeWordPiece) == (
        want == "native-cpp")
    warned = "native-cpp tokenizer but it is unavailable" in caplog.text
    assert warned == (prefer == "native-cpp" and not native)
    ids = enc.tokenize(trio[3][:8])
    assert [i.tolist() for i in ids] == [py.encode(t, max_len=64)
                                         for t in trio[3][:8]]
    with pytest.raises(ValueError):
        SentenceEncoder(cfg=cfg, tokenizer=py, prefer_tokenizer="rust",
                        device="cpu")


_AUDIT = """
import sys
seen = []
def hook(event, args):
    if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.rename"):
        seen.append(f"{event} {args!r}")
sys.addaudithook(hook)
for name in ("jax", "legal_rag_tpu"):
    sys.modules[name] = None
from legal_rag_tpu_torch import native_ext
native_ext.build_native(force=True)
forced = len(seen)
native_ext.build_native()
print(not [s for s in seen[forced:] if s.startswith("subprocess.Popen")])
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab)
vocab = build_wordpiece_vocab(["alpha beta"], 100)
text = "alpha beta, Łódź"
print(native_ext.NativeWordPiece(vocab).encode(text)
      == WordPieceTokenizer(vocab).encode(text))
print(native_ext.library_path())
print("\\n".join(seen))
"""


def test_library_lies_under_build_and_reads_nothing_of_the_jax_package():
    """A forced rebuild, a build that reuses it and a load, in a process
    where jax and the JAX package cannot be imported, through the
    kernels' builder (``utils/cuda_build.py build_shared_library``): the
    library lies under ``build/`` (which .gitignore lists), g++ compiles
    the port's copy, its pair encoder and the BM25 postings gather under
    a private name renamed into place, the unforced build runs no
    compiler, and no file under ``legal_rag_tpu/`` is opened, loaded or
    handed to the compiler."""
    out = subprocess.run([sys.executable, "-c", _AUDIT], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    reused, same, lib, *seen = out.stdout.strip().splitlines()
    assert reused == "True"
    assert same == "True"
    lib = Path(lib)
    renames = [s for s in seen if s.startswith("os.rename")]
    assert len(renames) == 1
    assert f"{lib.parent}/.libwordpiece." in renames[0]
    assert f"'{lib}'" in renames[0]
    assert lib.is_file()
    assert lib.is_relative_to(REPO_ROOT / "build" / "torch_native")
    assert "build/" in (REPO_ROOT / ".gitignore").read_text().split()
    assert "postings_gather.cpp" in native_ext.COMPILED
    for name in native_ext.COMPILED:
        assert any(f"legal_rag_tpu_torch/native/{name}" in s for s in seen)
    jax_pkg = str(REPO_ROOT / "legal_rag_tpu") + "/"
    assert not [s for s in seen if jax_pkg in s]
    assert (lib.parent / "g++.log").is_file()


@pytest.mark.parametrize("case", ["missing", "fails", "hangs"])
def test_a_compiler_that_fails_leaves_the_python_path(tmp_path, monkeypatch,
                                                      case):
    """No compiler, one that exits nonzero and one past
    ``COMPILE_TIMEOUT_S``: ``build_native`` returns False, not raising,
    and leaves no library and no half-written one; a compiler that ran
    leaves its log. ``build_shared_library`` itself raises, with the
    compiler's stderr."""
    from legal_rag_tpu_torch.utils import cuda_build

    cxx = tmp_path / "cxx"
    if case != "missing":
        cxx.write_text("#!/bin/sh\necho broken >&2\nexit 3\n"
                       if case == "fails" else "#!/bin/sh\nexec sleep 30\n")
        cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_ext, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "COMPILE_TIMEOUT_S", 1)
    assert native_ext.build_native() is False
    lib = native_ext.library_path()
    assert lib.is_relative_to(tmp_path / "build")
    assert not lib.exists()
    assert not list(lib.parent.glob(".lib*"))
    log = lib.parent / "g++.log"
    assert log.is_file() == (case != "missing")
    if case == "fails":
        assert "exit 3\nbroken" in log.read_text()
        with pytest.raises(RuntimeError, match="(?s)exit 3.*broken"):
            cuda_build.build_shared_library(
                "probe", [tmp_path / "cxx"], hashed=[],
                compiler=native_ext.find_cxx, flags=(),
                build_dir=tmp_path / "probe", log="cc.log")
    elif case == "hangs":
        assert "timed out after 1 seconds" in log.read_text()


def test_concurrent_builds_run_the_compiler_once(tmp_path):
    """Sixteen threads build one library at once (a fake compiler that
    counts its runs and writes an empty library): the compiler runs
    once, every thread gets the same path and log, and a forced build
    runs it again."""
    from legal_rag_tpu_torch.utils import cuda_build

    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\necho run >> {tmp_path}/runs\nsleep 0.2\n"
                   'while [ "$1" != -o ]; do shift; done\n: > "$2"\n')
    cxx.chmod(0o755)
    src = tmp_path / "probe.cpp"
    src.write_text("int probe() { return 0; }\n")

    def build(force=False):
        return cuda_build.build_shared_library(
            "probe", [src], hashed=[], compiler=lambda: str(cxx),
            flags=("-shared",), build_dir=tmp_path / "build", log="cc.log",
            force=force)

    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(lambda _: build(), range(16)))
    assert (tmp_path / "runs").read_text() == "run\n"
    assert len(set(got)) == 1
    lib, log = got[0]
    assert lib.is_file() and log.startswith(f"{cxx} -shared -o ")
    assert build(force=True)[0] == lib
    assert (tmp_path / "runs").read_text() == "run\nrun\n"


def test_jax_native_store_served_by_the_port(chunks, tmp_path):
    """A store the JAX package builds with its C++ tokenizer records
    ``native-cpp``; the port's engine pins it, and its query embeddings
    equal the JAX engine's within 1e-5."""
    if not (native_ext.native_available() and jax_native.native_available()):
        pytest.skip("no C++ compiler builds the native tokenizer")
    sub = chunks[:120]
    jax_build(sub, config=CFG, store_dir=tmp_path)
    assert JaxStore.load(tmp_path).encoder_info["tokenizer_impl"] == \
        "native-cpp"
    jax_engine = JaxEngine(JaxStore.load(tmp_path), config=CFG)
    port = RetrievalEngine(VectorStore.load(tmp_path), config=CFG,
                           device="cpu")
    assert port.encoder.tokenizer_impl == "native-cpp"
    assert jax_engine.encoder.tokenizer_impl == "native-cpp"
    queries = ["punishment for robbery", "धारा १७३ के अनुसार",
               "ΝΟΜΟΣ ΠΟΙΝΙΚΟΣ", "zero fir electronically"]
    np.testing.assert_allclose(port.encoder.encode(queries),
                               np.asarray(jax_engine.encoder.encode(queries)),
                               atol=EMB_TOL, rtol=0)
