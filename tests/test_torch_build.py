"""The port's index build against the JAX package's, on the CPU.

A corpus written in-test by ``ingest.synthetic.write_legal_corpus``
(five laws, sections with sub-sections, titles), parsed by the port's
ingest, and a small MiniLM (2 layers, hidden 64, 4 heads) whose weights
the JAX package draws and both packages take as numpy:

- ``build_index`` with that encoder, PQ (m=8, OPQ), IVF and a token
  slab in both packages: embeddings within 1e-5 (fp32 sums in another
  order), BM25 arrays, chunks and ``corpus_hash`` equal, the PQ stage
  as tests/test_torch_pq.py holds it (the same codebook codes and
  clusters alike; OPQ's trainings agree in quality, see
  ``_assert_pq_stage_matches``), the slab within one float16 step;
- without an encoder the port's numpy init has a hash of its own, so
  neither package resumes a store the other built with other weights,
  while with one encoder each package resumes the other's store;
- the resume cases of tests/test_resume.py;
- a store either package built serves in both engines with the same
  dense top-k (the tie-aware rule of tests/test_dense.py);
- ``evaluate_rerank`` with one cross-encoder checkpoint: MRR per alpha
  within 1e-6, the gate's decision and ``best_alpha`` equal;
- the labeled splits equal;
- the CLI's ``ingest`` -> ``build`` -> ``search`` (and ``finetune``,
  ``convert``) in a process where jax and the JAX package cannot load,
  the store then read by the JAX package.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from legal_rag_tpu import evaluation as jeval
from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig
from legal_rag_tpu.index.builder import build_index as jax_build
from legal_rag_tpu.index.store import VectorStore as JaxStore
from legal_rag_tpu.models.cross_encoder import CrossEncoder as JaxCE
from legal_rag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from legal_rag_tpu.models.minilm import init_minilm_params as jax_init
from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
from legal_rag_tpu_torch import evaluation as teval
from legal_rag_tpu_torch.index.builder import (
    _chunk_dicts, build_index, corpus_fingerprint,
)
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.cross_encoder import CrossEncoder
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
BUILD = dict(pq_m=8, ivf_cell_size=32, multi_vector=8)
EMB_TOL = 1e-5
QUERIES = ["punishment for robbery", "arrest of accused person",
           "compensation for acid attack", "evidence of electronic record",
           "procedure for zero fir registration"]


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def assert_topk_equiv(queries, docs, k, got_s, got_i, tol=1e-5):
    """tests/test_dense.py's rule: the top-k's scores equal the float64
    top-k values, every id above the k-th score's tie band is present,
    and nothing below it."""
    scores64 = queries.astype(np.float64) @ docs.T.astype(np.float64)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    for qi in range(queries.shape[0]):
        srt = np.sort(scores64[qi])[::-1]
        kth = srt[k - 1]
        np.testing.assert_allclose(got_s[qi], srt[:k], rtol=tol, atol=tol)
        assert (np.diff(got_s[qi]) <= tol).all()
        got_true = scores64[qi, got_i[qi]]
        np.testing.assert_allclose(got_s[qi], got_true, rtol=tol, atol=tol)
        must = np.where(scores64[qi] > kth + tol)[0]
        assert set(must) <= set(got_i[qi])
        assert (got_true >= kth - tol).all()


@pytest.fixture(scope="module")
def chunks(tmp_path_factory):
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    docs = tmp_path_factory.mktemp("build_docs")
    write_legal_corpus(docs, n_chunks=220, seed=7)
    return _chunk_dicts(parse_corpus(docs))


@pytest.fixture(scope="module")
def weights(chunks):
    vocab = build_wordpiece_vocab([c["text"] for c in chunks],
                                  size=CFG.encoder.vocab_size)
    cfg = dataclasses.replace(CFG.encoder, vocab_size=len(vocab))
    return vocab, cfg, _np_tree(jax_init(cfg, seed=3))


def _encoders(weights):
    vocab, cfg, params = weights
    return (
        JaxEncoder(cfg=cfg, params=params, tokenizer=WordPieceTokenizer(vocab),
                   prefer_tokenizer="python"),
        SentenceEncoder(cfg=cfg, params=params,
                        tokenizer=WordPieceTokenizer(vocab), device="cpu"),
    )


@pytest.fixture(scope="module")
def built(chunks, weights, tmp_path_factory):
    """(JAX store dir, port store dir, JAX store, port store), each
    built with the same encoder weights."""
    ref_enc, enc = _encoders(weights)
    jdir = tmp_path_factory.mktemp("jax_store")
    tdir = tmp_path_factory.mktemp("port_store")
    ref = jax_build(chunks, encoder=ref_enc, config=CFG, store_dir=jdir,
                    **BUILD)
    got = build_index(chunks, encoder=enc, config=CFG, store_dir=tdir,
                      device="cpu", **BUILD)
    return jdir, tdir, ref, got


def test_build_with_an_encoder_matches_jax(built):
    _, _, ref, got = built
    assert got.corpus_hash == ref.corpus_hash
    assert got.chunks == ref.chunks
    assert got.wp_vocab == ref.wp_vocab
    assert got.build_params == ref.build_params
    assert got.encoder_info == ref.encoder_info
    np.testing.assert_allclose(got.embeddings, ref.embeddings, rtol=0,
                               atol=EMB_TOL)
    for field in ("indptr", "doc_ids", "weights", "idf", "doc_len"):
        np.testing.assert_array_equal(getattr(got.bm25, field),
                                      getattr(ref.bm25, field))
    assert got.bm25.vocab == ref.bm25.vocab
    # PQ and IVF as tests/test_torch_pq.py holds them: from the same
    # codebook the port codes and clusters exactly as the JAX package
    _assert_pq_stage_matches(got, ref)
    np.testing.assert_array_equal(got.mv_mask, ref.mv_mask)
    assert got.mv_tokens.dtype == ref.mv_tokens.dtype == np.float16
    a, b = got.mv_tokens.astype(np.float32), ref.mv_tokens.astype(np.float32)
    step = np.maximum(np.spacing(np.abs(got.mv_tokens)),
                      np.spacing(np.abs(ref.mv_tokens))).astype(np.float32)
    assert (np.abs(a - b) <= step).all()
    # the weights the store carries are the encoder's, bit for bit
    for g, r in zip(*(_leaf_list(s.encoder_params) for s in (got, ref))):
        assert g.tobytes() == r.tobytes()


def _assert_pq_stage_matches(got, ref):
    """The build's PQ stage against the JAX package's. OPQ's 8 rounds of
    k-means and SVD amplify fp32 summation-order differences (a last-bit
    change in a centroid flips a near-tied assignment, and the rotation
    follows), so
    two trainings of one corpus agree in quality, not in bits. So: each
    store's codes are its codebook's coding of its embeddings; from the
    JAX store's codebook the port's ``encode_pq`` gives the JAX codes and
    its ``build_ivf`` the JAX cells; the port's codebook reconstructs
    the embeddings as well as JAX's (within 10%)."""
    from legal_rag_tpu_torch.ops import pq as tpq

    def cb(store):
        return tpq.PQCodebook(np.asarray(store.pq_codebooks),
                              np.asarray(store.pq_rotation))

    assert got.pq_codebooks.shape == ref.pq_codebooks.shape
    assert got.pq_codes.shape == ref.pq_codes.shape
    rot = np.asarray(got.pq_rotation, np.float64)
    np.testing.assert_allclose(rot @ rot.T, np.eye(rot.shape[0]), atol=1e-5)
    np.testing.assert_array_equal(
        tpq.encode_pq(got.embeddings, cb(got), device="cpu"), got.pq_codes)
    np.testing.assert_array_equal(
        tpq.encode_pq(ref.embeddings, cb(ref), device="cpu"), ref.pq_codes)
    ivf = tpq.build_ivf(ref.embeddings, cb(ref), ref.pq_codes,
                        cell_size=ref.ivf_cell_size, device="cpu")
    np.testing.assert_array_equal(ivf.doc_ids, ref.ivf_doc_ids)
    np.testing.assert_allclose(ivf.centroids, ref.ivf_centroids, rtol=0,
                               atol=1e-5)
    assert got.ivf_cell_size == ref.ivf_cell_size
    assert got.ivf_centroids.shape == ref.ivf_centroids.shape
    assert sorted(got.ivf_doc_ids[got.ivf_doc_ids >= 0]) == list(
        range(got.n_docs))

    def distortion(store):
        c = cb(store)
        rotated = np.asarray(store.embeddings) @ c.rotation
        return float(np.mean(
            (tpq.decode_pq(store.pq_codes, c) - rotated) ** 2))

    assert distortion(got) <= 1.1 * distortion(ref)


def _leaf_list(t):
    from legal_rag_tpu_torch.index.builder import tree_leaves

    return [np.asarray(x) for x in tree_leaves(t)]


def test_tree_leaves_follow_jax_order(weights):
    import jax

    params = weights[2]
    got = _leaf_list(params)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    assert len(got) == len(ref)
    assert all(g.shape == r.shape and np.array_equal(g, r)
               for g, r in zip(got, ref))


def test_saved_stores_load_in_both_packages(built):
    jdir, tdir, ref, got = built
    for store_dir, built_store in ((tdir, got), (jdir, ref)):
        for loaded in (JaxStore.load(store_dir), VectorStore.load(store_dir)):
            assert loaded.corpus_hash == built_store.corpus_hash
            np.testing.assert_array_equal(loaded.embeddings,
                                          built_store.embeddings)
            np.testing.assert_array_equal(loaded.pq_codes,
                                          built_store.pq_codes)
            np.testing.assert_array_equal(loaded.mv_tokens,
                                          built_store.mv_tokens)


@pytest.mark.parametrize("builder", ["port", "jax"])
def test_a_built_store_serves_the_same_dense_top_k_in_both(built, builder):
    """Each package's store, loaded by both packages' engines: the dense
    channel (weighted mode at weight 0) ranks as float64 does."""
    jdir, tdir, _, _ = built
    store_dir = tdir if builder == "port" else jdir
    jax_engine = JaxEngine(JaxStore.load(store_dir), config=CFG)
    port_engine = RetrievalEngine(VectorStore.load(store_dir), config=CFG,
                                  device="cpu")
    q = port_engine.encoder.encode(QUERIES)
    np.testing.assert_allclose(q, jax_engine.encoder.encode(QUERIES),
                               atol=EMB_TOL)
    docs = np.asarray(VectorStore.load(store_dir).embeddings)
    ids = {}
    for name, engine in (("jax", jax_engine), ("port", port_engine)):
        rows = engine.search_batch(QUERIES, k=10, hybrid_weights=[0.0] * 5,
                                   mode="weighted")
        s = [[r.score for r in row] for row in rows]
        ids[name] = [[r.doc_id for r in row] for row in rows]
        assert_topk_equiv(q, docs, 10, s, ids[name])
    rrf = [[[r.doc_id for r in row] for row in e.search_batch(QUERIES, k=10)]
           for e in (jax_engine, port_engine)]
    assert rrf[0] == rrf[1]


def test_default_init_hash_is_the_ports_own(chunks, tmp_path):
    """Without an encoder the port's numpy init makes other weights
    than the JAX package's random init: the hashes differ, a build in
    one package never reuses the other's store, and a repeat of the
    port's own build resumes."""
    texts = [c["text"] for c in chunks]
    jdir = tmp_path / "store"
    ref = jax_build(chunks, config=CFG, store_dir=jdir)
    got = build_index(chunks, config=CFG, store_dir=jdir, device="cpu")
    assert got.wp_vocab == ref.wp_vocab
    assert got.corpus_hash != ref.corpus_hash
    assert got.corpus_hash == corpus_fingerprint(texts, CFG, None)
    assert not np.allclose(got.embeddings, ref.embeddings, atol=1e-3)
    assert VectorStore.load(jdir).corpus_hash == got.corpus_hash
    mtime = (jdir / "embeddings.npy").stat().st_mtime_ns
    again = build_index(chunks, config=CFG, store_dir=jdir, device="cpu")
    assert (jdir / "embeddings.npy").stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(again.embeddings, got.embeddings)
    # and the JAX package, back in the port's directory, rebuilds
    back = jax_build(chunks, config=CFG, store_dir=jdir)
    assert back.corpus_hash == ref.corpus_hash
    assert (jdir / "embeddings.npy").stat().st_mtime_ns != mtime


@pytest.mark.parametrize("first", ["port", "jax"])
def test_one_encoder_resumes_across_packages(chunks, weights, tmp_path, first):
    ref_enc, enc = _encoders(weights)
    builds = {
        "port": lambda: build_index(chunks, encoder=enc, config=CFG,
                                    store_dir=tmp_path, device="cpu"),
        "jax": lambda: jax_build(chunks, encoder=ref_enc, config=CFG,
                                 store_dir=tmp_path),
    }
    s1 = builds[first]()
    mtime = (tmp_path / "embeddings.npy").stat().st_mtime_ns
    s2 = builds["jax" if first == "port" else "port"]()
    assert s2.corpus_hash == s1.corpus_hash
    assert (tmp_path / "embeddings.npy").stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(s1.embeddings, s2.embeddings)


# -- the resume cases of tests/test_resume.py, in the port ---------------

RCFG = RetrievalConfig(
    encoder=EncoderConfig(
        vocab_size=500, hidden=32, layers=1, heads=4,
        intermediate=64, max_len=32, encode_batch=64,
    )
)


def _chunks(texts):
    return [
        {"text": t, "metadata": {"law": "T"}, "canonical_header": f"H{i}"}
        for i, t in enumerate(texts)
    ]


def test_rebuild_skipped_when_corpus_unchanged(tmp_path):
    texts = ["alpha beta", "gamma delta", "epsilon zeta"]
    s1 = build_index(_chunks(texts), config=RCFG, store_dir=tmp_path,
                     device="cpu")
    assert s1.corpus_hash
    mtime = (tmp_path / "embeddings.npy").stat().st_mtime_ns
    s2 = build_index(_chunks(texts), config=RCFG, store_dir=tmp_path,
                     device="cpu")
    assert s2.corpus_hash == s1.corpus_hash
    assert (tmp_path / "embeddings.npy").stat().st_mtime_ns == mtime
    np.testing.assert_array_equal(s1.embeddings, s2.embeddings)


def test_rebuild_triggered_on_corpus_change(tmp_path):
    s1 = build_index(_chunks(["alpha beta"]), config=RCFG,
                     store_dir=tmp_path, device="cpu")
    s2 = build_index(_chunks(["alpha beta", "new document"]), config=RCFG,
                     store_dir=tmp_path, device="cpu")
    assert s2.corpus_hash != s1.corpus_hash
    assert s2.n_docs == 2


def test_rebuild_triggered_on_config_change(tmp_path):
    s1 = build_index(_chunks(["alpha beta"]), config=RCFG,
                     store_dir=tmp_path, device="cpu")
    cfg2 = dataclasses.replace(
        RCFG, encoder=dataclasses.replace(RCFG.encoder, hidden=64)
    )
    s2 = build_index(_chunks(["alpha beta"]), config=cfg2,
                     store_dir=tmp_path, device="cpu")
    assert s2.corpus_hash != s1.corpus_hash
    assert s2.dim == 64


def test_reloaded_store_encodes_queries_identically(tmp_path):
    texts = ["alpha beta gamma", "delta epsilon", "zeta eta theta"]
    enc = SentenceEncoder(cfg=RCFG.encoder, vocab_corpus=texts, seed=7,
                          device="cpu")
    # perturbed weights: the seed no longer explains them
    enc.params["embeddings"]["word"] = enc.params["embeddings"]["word"] + 0.1
    enc = SentenceEncoder(cfg=enc.cfg, params=enc.params,
                          tokenizer=enc.tokenizer, seed=7, device="cpu")
    build_index(_chunks(texts), encoder=enc, config=RCFG,
                store_dir=tmp_path, device="cpu")
    loaded = VectorStore.load(tmp_path)
    assert loaded.encoder_params is not None
    engine = RetrievalEngine(loaded, config=RCFG, device="cpu")
    np.testing.assert_allclose(
        engine.encoder.encode(["alpha beta"]), enc.encode(["alpha beta"]),
        atol=1e-6,
    )


def test_manifest_records_tokenizer_impl(tmp_path):
    store = build_index(_chunks(["alpha beta", "gamma delta"]), config=RCFG,
                        store_dir=tmp_path, device="cpu")
    assert store.manifest["encoder"]["tokenizer_impl"] == "python"
    engine = RetrievalEngine(VectorStore.load(tmp_path), config=RCFG,
                             device="cpu")
    assert engine.encoder.tokenizer_impl == "python"


# -- the rerank gate and the labeled splits -----------------------------


def test_evaluate_rerank_matches_jax(built, weights):
    """One CE checkpoint in both packages over the JAX-built store: the
    base and every alpha's MRR and recall within 1e-6, and the gate's
    decision and alpha equal."""
    from legal_rag_tpu.models.cross_encoder import train_cross_encoder_hard

    jdir, _, _, _ = built
    jstore, tstore = JaxStore.load(jdir), VectorStore.load(jdir)
    ref_enc, enc = _encoders(weights)
    jce = JaxCE(ref_enc, seed=2)
    train_cross_encoder_hard(jce, [c["text"] for c in jstore.chunks],
                             chunks=jstore.chunks, steps=2, seed=1)
    ckpt = _np_tree(jce.params)
    ce = CrossEncoder(enc, params=ckpt)
    pairs = jeval.labeled_pairs_from_chunks(jstore.chunks)
    valid = [p for i, p in enumerate(pairs) if not i % 7]
    assert len(valid) >= 10
    grid = (0.1, 0.25, 0.5, 0.75, 1.0)
    ref = jeval.evaluate_rerank(
        jstore, valid, JaxCE(ref_enc, params=ckpt), config=CFG,
        engine=JaxEngine(jstore, config=CFG, encoder=ref_enc), alphas=grid,
    )
    got = teval.evaluate_rerank(
        tstore, valid, ce, config=CFG,
        engine=RetrievalEngine(tstore, config=CFG, encoder=enc, device="cpu"),
        alphas=grid,
    )
    assert got.keys() == ref.keys() and got["modes"].keys() == ref["modes"].keys()
    for mode in ref["modes"]:
        for metric, value in ref["modes"][mode].items():
            assert abs(got["modes"][mode][metric] - value) <= 1e-6, (mode, metric)
    assert got["best_alpha"] == ref["best_alpha"]

    def accept(report):
        return report["modes"]["reranked"]["mrr"] >= report["modes"]["base"]["mrr"]

    assert accept(got) == accept(ref)


def test_labeled_splits_match_jax(chunks):
    assert (teval.labeled_pairs_from_chunks(chunks)
            == jeval.labeled_pairs_from_chunks(chunks))
    assert (teval.labeled_pairs_from_chunks(chunks, max_pairs=20, seed=3)
            == jeval.labeled_pairs_from_chunks(chunks, max_pairs=20, seed=3))
    assert (teval.paraphrase_pairs_from_chunks(chunks)
            == jeval.paraphrase_pairs_from_chunks(chunks))
    assert (teval.sibling_span_pairs_from_chunks(chunks, max_pairs=30)
            == jeval.sibling_span_pairs_from_chunks(chunks, max_pairs=30))
    assert len(teval.labeled_pairs_from_chunks(chunks)) >= 40


def test_evaluate_store_matches_jax(built, weights):
    jdir, _, _, _ = built
    jstore, tstore = JaxStore.load(jdir), VectorStore.load(jdir)
    ref_enc, enc = _encoders(weights)
    pairs = jeval.labeled_pairs_from_chunks(jstore.chunks)
    modes = ("dense", "bm25", "weighted", "rrf", "pq")
    ref = jeval.evaluate_store(jstore, pairs, modes=modes, config=CFG,
                               encoder=ref_enc)
    got = teval.evaluate_store(tstore, pairs, modes=modes, config=CFG,
                               encoder=enc, device="cpu")
    for mode in modes:
        for metric, value in ref["modes"][mode].items():
            assert abs(got["modes"][mode][metric] - value) <= 1e-6, (mode, metric)


# -- the command line, without jax --------------------------------------

_BLOCK = (
    "import sys\n"
    "for _name in ('jax', 'optax', 'legal_rag_tpu'):\n"
    "    sys.modules[_name] = None\n"
)


def _run_blocked(code: str, timeout: int = 600) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK + code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=timeout,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_cli_ingest_build_search_without_jax(tmp_path):
    """markdown -> chunks -> a store with every build stage on -> an
    answered query, in a process that cannot import jax; then the JAX
    package loads the store and ranks the query the same."""
    out = _run_blocked(f"""
from legal_rag_tpu_torch.cli import main
from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus
d = {str(tmp_path)!r}
write_legal_corpus(d + "/docs", n_chunks=60, seed=1)
assert main(["ingest", "--docs", d + "/docs", "--out", d + "/chunks.json",
             "--debug-dump", d + "/debug.txt"]) == 0
assert main(["build", "--source", d + "/chunks.json", "--store", d + "/store",
             "--device", "cpu", "--finetune-steps", "1",
             "--finetune-token-weight", "0.5", "--finetune-augment", "0.3",
             "--finetune-augment-kinds", "register,dropout",
             "--pq-m", "8", "--ivf-cell-size", "16", "--rerank-steps", "2",
             "--rerank-sibling-prob", "0.5", "--multi-vector", "8"]) == 0
assert main(["search", "--store", d + "/store", "--query",
             "punishment for robbery", "--k", "3", "--device", "cpu"]) == 0
print("JAX_MODULES", sorted(m for m in sys.modules
      if m.split(".")[0] in ("jax", "legal_rag_tpu")
      and sys.modules[m] is not None))
""")
    assert "JAX_MODULES []" in out
    assert "chunks -> " in out and "fine-tuned 1 steps" in out
    assert "build stages (s): " in out
    hits = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert len(hits) == 3
    chunks = json.loads((tmp_path / "chunks.json").read_text())
    assert len(chunks) >= 55 and (tmp_path / "debug.txt").exists()

    store = JaxStore.load(tmp_path / "store")
    assert store.n_docs == len(chunks) and store.pq_codes.shape[1] == 8
    assert store.ivf_centroids is not None and store.mv_tokens.shape[1] == 8
    assert store.build_params["finetune_augment_kinds"] == "register,dropout"
    top = JaxEngine(store).search("punishment for robbery", k=3)
    assert [r["chunk"]["canonical_header"].replace("\n", " | ")
            for r in top] == [h.split("  ", 1)[1] for h in hits]


def test_cli_finetune_and_convert_without_jax(tmp_path):
    """``finetune`` writes the tuned weights of a store's encoder;
    ``convert`` turns an HF state dict into the params the JAX
    package's converter makes."""
    from legal_rag_tpu.models.convert import (
        convert_hf_bert as jax_convert, load_params_npz,
    )
    from legal_rag_tpu_torch.models.minilm import init_minilm_params

    cfg = EncoderConfig(vocab_size=80, hidden=32, layers=6, heads=4,
                        intermediate=64, max_len=32)
    params = init_minilm_params(cfg, seed=1)
    sd = {"embeddings.word_embeddings.weight": params["embeddings"]["word"],
          "embeddings.position_embeddings.weight":
              params["embeddings"]["position"],
          "embeddings.token_type_embeddings.weight":
              params["embeddings"]["token_type"],
          "embeddings.LayerNorm.weight": params["embeddings"]["ln"]["scale"],
          "embeddings.LayerNorm.bias": params["embeddings"]["ln"]["bias"]}
    names = {"attention.self.query": ("attention", "query"),
             "attention.self.key": ("attention", "key"),
             "attention.self.value": ("attention", "value"),
             "attention.output.dense": ("attention", "output"),
             "intermediate.dense": ("intermediate",),
             "output.dense": ("output",)}
    for n, lp in enumerate(params["layers"]):
        for hf, path in names.items():
            p = lp[path[0]] if len(path) == 1 else lp[path[0]][path[1]]
            sd[f"encoder.layer.{n}.{hf}.weight"] = p["kernel"].T.copy()
            sd[f"encoder.layer.{n}.{hf}.bias"] = p["bias"]
        for hf, key in (("attention.output.LayerNorm", "attention_ln"),
                        ("output.LayerNorm", "output_ln")):
            sd[f"encoder.layer.{n}.{hf}.weight"] = lp[key]["scale"]
            sd[f"encoder.layer.{n}.{hf}.bias"] = lp[key]["bias"]
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               tmp_path / "model.bin")
    texts = ["alpha beta gamma delta", "delta epsilon zeta", "eta theta iota"]
    store_cfg = RetrievalConfig(encoder=dataclasses.replace(cfg, layers=1))
    build_index([{"text": t, "metadata": {}} for t in texts],
                config=store_cfg, store_dir=tmp_path / "store", device="cpu")
    out = _run_blocked(f"""
from legal_rag_tpu_torch.cli import main
d = {str(tmp_path)!r}
assert main(["convert", "--checkpoint", d + "/model.bin",
             "--out", d + "/params.npz"]) == 0
assert main(["finetune", "--store", d + "/store", "--out", d + "/tuned.npz",
             "--steps", "2", "--batch", "4", "--device", "cpu"]) == 0
""")
    assert "converted" in out and "fine-tuned 2 steps" in out
    got = load_params_npz(tmp_path / "params.npz")
    ref = jax_convert(sd, EncoderConfig())
    from legal_rag_tpu_torch.index.builder import tree_leaves

    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        assert np.asarray(g).tobytes() == np.asarray(r).tobytes()
    tuned = load_params_npz(tmp_path / "tuned.npz")
    before = VectorStore.load(tmp_path / "store").encoder_params
    shapes = [np.shape(x) for x in tree_leaves(before)]
    assert [np.shape(x) for x in tree_leaves(tuned)] == shapes
    assert not np.array_equal(tuned["embeddings"]["word"],
                              before["embeddings"]["word"])


def test_train_reranker_script_gates_a_store(tmp_path, monkeypatch, capsys):
    """The script trains a CE on an existing store, runs the index build's
    gate and reports it as its last line (nothing saved with
    ``RR_SAVE=0``)."""
    from legal_rag_tpu_torch.scripts import train_reranker

    chunks = [{"text": f"Section {i} punishment for robbery term{i} "
                       f"word{i % 3} rule", "metadata": {
                           "law": "BNS", "section": str(i),
                           "section_title": f"Punishment for case {i % 5}"}}
              for i in range(24)]
    build_index(chunks, config=RCFG, store_dir=tmp_path, device="cpu")
    for key, value in (("RR_STEPS", "2"), ("RR_DEVICE", "cpu"),
                       ("RR_SAVE", "0")):
        monkeypatch.setenv(key, value)
    assert train_reranker.main([str(tmp_path)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 2 and isinstance(last["passed"], bool)
    assert VectorStore.load(tmp_path).ce_params is None


def test_compare_encoders_reports_both_encoders(chunks):
    report = teval.compare_encoders(chunks[:120], config=CFG,
                                    finetune_steps=2, finetune_batch=8,
                                    device="cpu")
    assert report["finetune"]["steps"] == 2
    for key in ("random_encoder", "finetuned_encoder"):
        assert set(report[key]) == {"dense", "bm25", "weighted", "rrf"}
        assert 0.0 <= report[key]["rrf"]["mrr"] <= 1.0
