"""The port's evaluation and kernel scripts against the JAX package's, on
the CPU, at small sizes.

- The eval scripts (``eval_fusion_policy``, ``exp_paraphrase_sparse``,
  ``diag_paraphrase``, ``eval_ce_paraphrase``) run over one JAX-built
  store of the synthetic legal corpus with a cross-encoder persisted on
  purpose (two training steps; the build's gate would reject so weak a
  checkpoint) and give the JAX script's report on it within 1e-6 (the
  bootstraps from one seed). The JAX scripts run in a process of their
  own on one CPU device, as the port's engine is one device.
- ``eval_ablation`` runs ``compare_encoders`` over a markdown corpus.
- The PQ scripts hold both packages to one codebook, trained once by the
  JAX package (OPQ is chaotic in fp32, so two trainings agree in
  quality, not in bits): ``exp_ivf_recovery_recall``'s numpy mirror
  gives the JAX mirror's recall and the port's own dispatch's candidate
  sets; ``exp_ivf_recovery``'s recall equals the mirror's; ``bench_pq``'s
  candidate recall equals the JAX ``pq_topk``'s and ``pq_ivf_topk``'s
  (Pallas interpret mode) on the same codes.
- The kernel scripts (``exp_rm_sweep``, ``exp_twophase_full``, and the
  PQ ones) leave ``ms`` None on the CPU, and each two-phase row's
  top-10 is the exact flat select's (recall 1.0); their ``main()`` needs
  a card.
"""

import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig
from legal_rag_tpu.index.builder import build_index as jax_build
from legal_rag_tpu.index.store import VectorStore as JaxStore
from legal_rag_tpu.models.cross_encoder import CrossEncoder as JaxCE
from legal_rag_tpu.models.cross_encoder import train_cross_encoder_hard
from legal_rag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from legal_rag_tpu.models.minilm import init_minilm_params as jax_init
from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
from legal_rag_tpu_torch.index.builder import _chunk_dicts
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = REPO_ROOT / "scripts"
TOL = 1e-6
ENCODER = EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                        intermediate=128, max_len=64, encode_batch=64)
CARD_SCRIPTS = ["exp_rm_sweep", "exp_twophase_full", "bench_pq",
                "exp_ivf_recovery"]


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def assert_close(got, want, path=""):
    """Nested reports equal, floats within TOL (JSON round trip first)."""
    got = json.loads(json.dumps(got))
    want = json.loads(json.dumps(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(markdown dir, chunks) of the synthetic legal corpus, 220 chunks."""
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    docs = tmp_path_factory.mktemp("eval_docs")
    write_legal_corpus(docs, n_chunks=220, seed=7)
    return docs, _chunk_dicts(parse_corpus(docs))


@pytest.fixture(scope="module")
def store_dir(corpus, tmp_path_factory):
    """A JAX-built store (a 2-layer MiniLM drawn by the JAX package, PQ,
    IVF, a token slab) with a 2-step JAX cross-encoder persisted at
    alpha 0.5. Its name is unique: the JAX fusion script caches
    rankings under /tmp by the store's name."""
    _, chunks = corpus
    cfg = RetrievalConfig(encoder=ENCODER,
                          sharding=ShardingConfig(num_shards=1))
    vocab = build_wordpiece_vocab([c["text"] for c in chunks], size=1500)
    enc_cfg = dataclasses.replace(ENCODER, vocab_size=len(vocab))
    enc = JaxEncoder(cfg=enc_cfg, params=_np_tree(jax_init(enc_cfg, seed=3)),
                     tokenizer=WordPieceTokenizer(vocab),
                     prefer_tokenizer="python")
    path = tmp_path_factory.mktemp("eval_store") / f"store_{uuid.uuid4().hex}"
    jax_build(chunks, encoder=enc, config=cfg, store_dir=path, pq_m=8,
              ivf_cell_size=32, multi_vector=8)
    store = JaxStore.load(path)
    ce = JaxCE(JaxEngine(store, config=cfg).encoder, seed=2)
    train_cross_encoder_hard(ce, [c["text"] for c in store.chunks],
                             chunks=store.chunks, steps=2, seed=1)
    store.ce_params, store.ce_alpha = _np_tree(ce.params), 0.5
    store.save(path)
    yield path
    for f in glob.glob(f"/tmp/fusion_rank_cache_{path.name}_*.npz"):
        os.remove(f)


def run_jax_script(name: str, argv, patch_cache: bool = False) -> None:
    """``scripts/<name>.py``'s ``main()`` with ``argv``, in a process of
    its own on one CPU device (``patch_cache``: its compile cache off)."""
    code = (
        "import importlib.util, sys\n"
        + ("import legal_rag_tpu.utils.cache as c\n"
           "c.enable_compile_cache = lambda *a, **k: None\n"
           if patch_cache else "")
        + f"spec = importlib.util.spec_from_file_location('s', "
        f"{str(SCRIPTS / (name + '.py'))!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"sys.argv = ['{name}'] + {list(map(str, argv))!r}\n"
        "m.main()\n"
    )
    env = {**os.environ, "XLA_FLAGS": "", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]


def jax_script_module(name: str):
    """A JAX script whose import has no side effect, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- the eval scripts against the JAX scripts ----------------------------


def test_fusion_policy_matches_jax(store_dir, tmp_path):
    from legal_rag_tpu_torch.scripts import eval_fusion_policy

    report = tmp_path / "jax.json"
    run_jax_script("eval_fusion_policy", ["--store", store_dir, "--max-pairs",
                                          "60", "--bootstrap", "200",
                                          "--report", report])
    want = json.loads(report.read_text())
    got = eval_fusion_policy.run(VectorStore.load(store_dir), max_pairs=60,
                                 bootstrap=200, seed=0, device="cpu",
                                 log=lambda s: None)
    assert_close(got["splits"], want["splits"])
    assert got["provenance"]["platform"] == "cpu"
    assert got["provenance"]["cross_encoder"] is True


def test_paraphrase_sparse_matches_jax(store_dir, tmp_path):
    from legal_rag_tpu_torch.scripts import exp_paraphrase_sparse

    report = tmp_path / "jax.json"
    run_jax_script("exp_paraphrase_sparse", ["--store", store_dir,
                                             "--report", report])
    want = json.loads(report.read_text())
    got = exp_paraphrase_sparse.run(VectorStore.load(store_dir).chunks,
                                    log=lambda s: None)
    assert_close(got["splits"], want["splits"])
    assert [len(s["modes"]) for s in got["splits"].values()] == [6, 6]


def test_diag_paraphrase_matches_jax(store_dir, tmp_path):
    from legal_rag_tpu_torch.quality import PARAPHRASE_SUITE
    from legal_rag_tpu_torch.scripts import diag_paraphrase

    report = tmp_path / "jax.json"
    run_jax_script("diag_paraphrase", ["--store", store_dir, "--report",
                                       report])
    want = json.loads(report.read_text())
    got = diag_paraphrase.run(store_dir, device="cpu", log=lambda s: None)
    assert_close(got["rows"], want["rows"])
    assert got["summary"] == want["summary"]
    assert (got["mode"], got["k"]) == (want["mode"], want["k"])
    assert len(got["rows"]) == len(PARAPHRASE_SUITE)
    # the store carries a cross-encoder, so every row went through it
    assert all("rerank_rank" in r for r in got["rows"])


def test_eval_ce_paraphrase_matches_jax(store_dir, tmp_path):
    from legal_rag_tpu_torch.scripts import eval_ce_paraphrase

    report = tmp_path / "jax.json"
    run_jax_script("eval_ce_paraphrase", ["--store", store_dir, "--n", "40",
                                          "--report", report],
                   patch_cache=True)
    want = json.loads(report.read_text())
    got = eval_ce_paraphrase.run(VectorStore.load(store_dir), n=40,
                                 device="cpu", log=lambda s: None)
    assert_close(got["splits"], want["splits"])
    assert got["serving_alpha"] == want["serving_alpha"] == 0.5
    assert got["provenance"]["platform"] == "cpu"


def test_eval_ce_paraphrase_needs_a_checkpoint(store_dir, tmp_path):
    from legal_rag_tpu_torch.scripts import eval_ce_paraphrase

    store = VectorStore.load(store_dir)
    store.ce_params = None
    with pytest.raises(ValueError, match="cross_encoder"):
        eval_ce_paraphrase.run(store, n=4, device="cpu")


def test_eval_ablation_compares_encoders(corpus, tmp_path):
    from legal_rag_tpu import evaluation as jeval
    from legal_rag_tpu_torch.config import (
        EncoderConfig as TEncoderConfig, RetrievalConfig as TConfig,
    )
    from legal_rag_tpu_torch.scripts import eval_ablation

    docs, chunks = corpus
    cfg = TConfig(encoder=TEncoderConfig(**dataclasses.asdict(ENCODER)))
    report = eval_ablation.run(str(docs), finetune_steps=2, finetune_batch=8,
                               max_pairs=30, config=cfg, device="cpu",
                               log=lambda s: None)
    assert report["n_queries"] == len(jeval.labeled_pairs_from_chunks(
        chunks, max_pairs=30)) == 30
    assert report["finetune"]["steps"] == 2
    for side in ("random_encoder", "finetuned_encoder"):
        assert set(report[side]) == {"dense", "bm25", "weighted", "rrf"}
        for entry in report[side].values():
            assert set(entry) == {"recall@1", "recall@5", "recall@10", "mrr"}
            assert all(0.0 <= v <= 1.0 for v in entry.values())
    # BM25 does not depend on the encoder
    assert report["random_encoder"]["bm25"] == report["finetuned_encoder"]["bm25"]


# -- the PQ scripts, one codebook -----------------------------------------

N_PQ, Q_PQ = 8192, 16


@pytest.fixture(scope="module")
def shared_codebooks():
    """``train_fn`` for the port's scripts: the JAX package's training of
    the scripts' codebook, once per corpus, kept for the JAX side."""
    from legal_rag_tpu.ops import pq as jpq
    from legal_rag_tpu_torch.ops import pq as tpq

    trained = {}

    def train_fn(docs, device):
        key = (docs.shape, float(docs[:4].sum()))
        if key not in trained:
            trained[key] = jpq.train_pq(docs, m=48, iters=15, sample=32768,
                                        opq_iters=4)
        return tpq.PQCodebook(*trained[key])

    return train_fn, trained


def test_ivf_recovery_recall_matches_the_jax_mirror(shared_codebooks):
    from legal_rag_tpu.ops import pq as jpq
    from legal_rag_tpu_torch.scripts import exp_ivf_recovery_recall as rr
    from legal_rag_tpu_torch.scripts.exp_ivf_recovery import clustered_corpus

    train_fn, trained = shared_codebooks
    rows = rr.run(N_PQ, Q_PQ, oversamples=(4, 16), device="cpu",
                  log=lambda s: None, train_fn=train_fn)
    jrr = jax_script_module("exp_ivf_recovery_recall")
    docs, qs = clustered_corpus(N_PQ, Q_PQ)
    cb = trained[(docs.shape, float(docs[:4].sum()))]
    codes = jpq.encode_pq(docs, cb)
    ivf = jpq.build_ivf(docs, cb, codes, cell_size=1024)
    jrr.CBS = np.asarray(cb.codebooks)
    qrot = np.asarray(cb.rotate(qs), np.float32)
    nib_cell = jrr.unpack_codes(np.asarray(ivf.codes))
    flat = jrr.pq_scores(qrot, jrr.unpack_codes(np.asarray(codes)), jrr.CBS)
    gold = [set(np.argsort(-(qs[i] @ docs.T), kind="stable")[:10])
            for i in range(Q_PQ)]
    assert [(r["dispatch"], r["oversample"]) for r in rows] == [
        (d, x) for d in ("flat", "ivf256", "ivf512") for x in (4, 16)]
    for row in rows:
        kk = row["candidates"]
        cand = (np.argsort(-flat, axis=1, kind="stable")[:, :kk]
                if row["dispatch"] == "flat" else jrr.ivf_candidates(
                    qrot, ivf, nib_cell, kk, probes=int(row["dispatch"][3:])))
        want = []
        for i in range(Q_PQ):
            ids = np.unique(cand[i][cand[i] >= 0])
            top = ids[np.argsort(-(qs[i] @ docs[ids].T), kind="stable")[:10]]
            want.append(len(set(top.tolist()) & gold[i]) / 10)
        assert abs(row["recall"] - float(np.mean(want))) <= TOL, row
        # the mirror's candidates are the port's own dispatch's
        assert row["overlap"] == 1.0, row


def test_ivf_recovery_rows(shared_codebooks):
    from legal_rag_tpu_torch.scripts import exp_ivf_recovery as rec
    from legal_rag_tpu_torch.scripts import exp_ivf_recovery_recall as rr

    train_fn, _ = shared_codebooks
    kw = dict(oversamples=(4, 16), device="cpu", log=lambda s: None,
              train_fn=train_fn)
    rows = rec.run(N_PQ, Q_PQ, iters=1, warmup=0, **kw)
    mirror = rr.run(N_PQ, Q_PQ, **kw)
    assert len(rows) == len(mirror) == 6
    for row, want in zip(rows, mirror):
        assert row["ms"] is None and row["gbps"] is None
        assert (row["dispatch"], row["oversample"], row["candidates"]) == (
            want["dispatch"], want["oversample"], want["candidates"])
        assert abs(row["recall"] - want["recall"]) <= TOL
        assert row["rescore_ms_per_q"] >= 0.0
    # the cells cover every doc here (8 cells <= 256 probes): IVF is flat
    assert [r["recall"] for r in rows[:2]] == [r["recall"] for r in rows[2:4]]


def test_bench_pq_recall_matches_jax(shared_codebooks):
    import jax.numpy as jnp
    from legal_rag_tpu.ops import pq as jpq
    from legal_rag_tpu_torch.scripts import bench_pq

    train_fn, trained = shared_codebooks
    n, n_small, probes = 20_000, 5_000, (4, 8)
    rows = bench_pq.run(n, recall_docs=n_small, probes=probes, device="cpu",
                        log=lambda s: None, iters=1, warmup=0,
                        train_fn=train_fn)
    names = [r["name"] for r in rows]
    assert names == [
        "pq_topk sr=8 Q=64 k=80", "K2 pq_segmax sr=8 Q=64",
        "pq_topk sr=16 Q=64 k=80", "K2 pq_segmax sr=16 Q=64",
        f"candidate recall@10 k=80 n={n_small}", "flat Q=16",
        *(f"ivf p={p} Q=16" for p in probes)]
    assert all(r["ms"] is None and "note" not in r for r in rows)

    # the JAX script's draws, in its order, and its candidate recall
    rng = np.random.default_rng(0)
    rng.integers(0, 256, (n, 48), dtype=np.uint8)
    rng.standard_normal((96, 16, 4))
    rng.standard_normal((64, 384))
    centers = rng.standard_normal((2048, 384)).astype(np.float32)
    small = bench_pq.clustered(rng, centers, n_small, 16)
    big = bench_pq.clustered(rng, centers, n, 16)

    def jax_recall(docs, qs, search):
        cb = trained[(docs.shape, float(docs[:4].sum()))]
        codes = jpq.encode_pq(docs, cb)
        _, ids = search(cb, codes, jnp.asarray(cb.rotate(qs)))
        return bench_pq.candidate_recall(np.asarray(ids), qs @ docs.T)

    flat = lambda cb, codes, q: jpq.pq_topk(
        q, jnp.asarray(codes), jnp.asarray(cb.codebooks), 80, interpret=True)
    want = [jax_recall(*small, flat), jax_recall(*big, flat)]
    for p in probes:
        want.append(jax_recall(*big, lambda cb, codes, q, p=p: jpq.pq_ivf_topk(
            q, jpq.build_ivf(big[0], cb, codes, cell_size=1024),
            cb.codebooks, 80, probes=p, interpret=True)))
    got = [r["recall"] for r in rows[4:]]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# -- the kernel scripts ---------------------------------------------------


def test_rm_sweep_rows_are_exact(monkeypatch):
    import legal_rag_tpu_torch.ops.dense as tdense
    from legal_rag_tpu_torch.scripts import exp_rm_sweep

    monkeypatch.setattr(tdense, "_TWO_LEVEL_MIN_SEGS", 1)
    n = 40_000     # padded to 40,960 at block_n 8192, 49,152 at 16384
    rows = exp_rm_sweep.run(n, configs=((8192, 8), (16384, 16), (8192, 32)),
                            device="cpu", log=lambda s: None)
    assert [r["name"] for r in rows] == [
        "matmul+topk", "rm bn=8192 sr=8", "rm bn=16384 sr=16",
        "rm bn=8192 sr=32", "rm int8 sr=8", "rm sr=8 sup=64",
        "rm sr=8 sup=256"]
    assert all(r["ms"] is None and r["gbps"] is None for r in rows)
    assert [r["n_pad"] for r in rows[1:4]] == [40_960, 49_152, 40_960]
    two_phase = rows[1:]
    assert all(r["match"] for r in two_phase)
    assert all(r["recall"] == 1.0 for r in two_phase if "int8" not in r["name"])
    assert 0.5 <= rows[4]["recall"] <= 1.0


def test_twophase_full_rows_are_exact():
    import legal_rag_tpu_torch.ops.dense as tdense
    from legal_rag_tpu_torch.scripts import exp_twophase_full

    before = tdense._TIE_OVERSAMPLE
    rows = exp_twophase_full.run(20_000, device="cpu", log=lambda s: None)
    assert tdense._TIE_OVERSAMPLE == before
    assert [r["name"] for r in rows] == [
        "unpadded", "prepadded", "prepad+kk32", "prepad+noemit"]
    assert all(r["ms"] is None and r["peak_extra_mb"] is None for r in rows)
    assert all(r["match"] and r["recall"] == 1.0 for r in rows[:3])
    assert "match" not in rows[3]


@pytest.mark.parametrize("name", CARD_SCRIPTS)
def test_card_script_main_needs_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = importlib.import_module(f"legal_rag_tpu_torch.scripts.{name}")
    assert script.main() != 0
    assert "needs a CUDA card" in capsys.readouterr().err


@pytest.mark.parametrize("name", [
    "eval_ablation", "eval_fusion_policy", "exp_paraphrase_sparse",
    "diag_paraphrase", "eval_ce_paraphrase", "exp_ivf_recovery_recall"])
def test_script_report_is_opt_in(name):
    """No script writes a report unless ``--report`` names one (the
    repository's EVAL_*.json and DIAG_*.json are the JAX package's)."""
    script = importlib.import_module(f"legal_rag_tpu_torch.scripts.{name}")
    src = Path(script.__file__).read_text()
    assert '"--report", default=None' in src
    assert not re.search(r'default="/', src)     # no absolute default path
