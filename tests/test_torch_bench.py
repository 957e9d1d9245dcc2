"""The port's headline bench (``legal_rag_tpu_torch/bench.py``) against
the JAX package's ``bench.py``, on the CPU over a 300-chunk synthetic
store built once here with a narrow MiniLM:

- ``sample_queries`` gives the JAX bench's queries for the same store
  and seed; ``cpu_baseline`` its ids and scores exactly on the same
  seeded arrays; ``bench_inputs`` the arrays of its ``main``.
- The device path (``searchers``, ``device="cpu"``) equals the JAX
  ``sharded_hybrid_search`` on a one-device CPU mesh over the same
  embeddings, postings and weights: fused scores within 1e-5 (fp32 dot
  products and BM25 sums in another order), ids under the tie rule.
- ``run(device="cpu")`` with small slopes: recall@5 1.0 against the
  exact golden, every number finite and positive, and a last stdout line
  equal to the record the JAX ``run`` prints for the same two rates.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from legal_rag_tpu_torch import bench

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _load_jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_under_test", REPO_ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return _load_jax_bench()


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    from legal_rag_tpu_torch.config import (
        EncoderConfig, RetrievalConfig, ShardingConfig,
    )
    from legal_rag_tpu_torch.index.builder import build_index
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    root = tmp_path_factory.mktemp("bench_store")
    write_legal_corpus(root / "docs", n_chunks=300, seed=5)
    cfg = RetrievalConfig(
        encoder=EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                              intermediate=128, max_len=64),
        sharding=ShardingConfig(num_shards=1),
    )
    build_index(root / "docs", config=cfg, store_dir=root / "store",
                device="cpu")
    return str(root / "store")


@pytest.fixture(scope="module")
def store(store_dir):
    from legal_rag_tpu_torch.index.store import VectorStore

    return VectorStore.load(store_dir)


@pytest.fixture(scope="module")
def inputs(store):
    """The bench's queries and search inputs over the store."""
    queries = bench.sample_queries(store, bench.Q_BATCH)
    return queries, bench.bench_inputs(store, queries)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_queries_are_the_jax_benchs(store, jax_bench, seed):
    assert bench.sample_queries(store, 64, seed=seed) == \
        jax_bench.sample_queries(store, 64, seed=seed)


def test_bench_inputs_are_the_jax_benchs_main(store, inputs, jax_bench):
    """The arrays of the JAX ``main`` (bench.py:201-211), written out."""
    queries, (q_emb, post_ids, post_w, weights, budget) = inputs
    rng = np.random.default_rng(1)
    rows = rng.integers(0, store.n_docs, jax_bench.Q_BATCH)
    want = store.embeddings[rows] + 0.05 * rng.standard_normal(
        (jax_bench.Q_BATCH, store.dim)).astype(np.float32)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(q_emb, want)
    want_budget = max(64, store.bm25.postings_budget(queries))
    want_budget = 1 << (want_budget - 1).bit_length()
    assert budget == want_budget
    ids, w = store.bm25.gather_postings(queries, want_budget)
    np.testing.assert_array_equal(post_ids, ids)
    np.testing.assert_array_equal(post_w, w)
    np.testing.assert_array_equal(
        weights, np.full(jax_bench.Q_BATCH, 0.5, np.float32))


def test_cpu_baseline_is_the_jax_benchs(store, inputs, jax_bench):
    _, (q_emb, post_ids, post_w, weights, _) = inputs
    f, ids, dt = bench.cpu_baseline(store, q_emb, post_ids, post_w,
                                    weights, bench.K)
    jf, jids, jdt = jax_bench.cpu_baseline(store, q_emb, post_ids, post_w,
                                           weights, jax_bench.K)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(f, jf)
    assert dt > 0 and jdt > 0


def _jax_search(store, q_emb, post_ids, post_w, weights, rows):
    import jax.numpy as jnp
    from legal_rag_tpu.parallel.mesh import make_mesh
    from legal_rag_tpu.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    mesh = make_mesh(1)
    index = ShardedIndex.from_embeddings(store.embeddings, mesh)
    f, ids, _, _ = sharded_hybrid_search(
        index.docs, jnp.asarray(post_ids[:rows]), jnp.asarray(post_w[:rows]),
        jnp.asarray(q_emb[:rows]), jnp.asarray(weights[:rows]), mesh=mesh,
        k=bench.K, c=2 * bench.K, n_docs=store.n_docs, mode="weighted",
    )
    return np.asarray(f), np.asarray(ids)


@pytest.mark.parametrize("rows", [bench.Q_BATCH, bench.SINGLE_Q])
def test_device_search_matches_jax_sharded_hybrid(store, inputs, rows):
    _, (q_emb, post_ids, post_w, weights, _) = inputs
    _, searches = bench.searchers(store, q_emb, post_ids, post_w, weights,
                                  device="cpu", rows=(rows,))
    got_f, got_i, _, _ = (t.numpy() for t in searches[0]())
    ref_f, ref_i = _jax_search(store, q_emb, post_ids, post_w, weights,
                               rows)
    np.testing.assert_allclose(got_f, ref_f, atol=TOL, rtol=0)
    band = ref_f[:, -1:] + TOL      # above it no doc can be tied out
    for r in range(rows):
        assert set(got_i[r][got_f[r] > band[r]]) <= set(ref_i[r])
        assert set(ref_i[r][ref_f[r] > band[r]]) <= set(got_i[r])
    gold_f, gold_i = bench.exact_golden(store, q_emb[:rows], post_ids[:rows],
                                        post_w[:rows])
    np.testing.assert_allclose(got_f, gold_f, atol=TOL, rtol=0)
    assert bench.recall_at_k(got_i, gold_i) == 1.0


def test_run_prints_the_jax_record(store_dir, jax_bench, monkeypatch, capsys,
                                   tmp_path):
    # one intra-op thread: the slopes time the CPU, and several test
    # workers' thread pools oversubscribing it can stall a short run
    # past a long one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics, arrays = bench.run(device="cpu", store_dir=store_dir,
                                    slope_r=(2, 16), log=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert metrics["timing"] == "eager" and metrics["device"] == "cpu"
    assert metrics["recall_at_k"] == 1.0
    for key in ("dev_qps", "cpu_qps", "batch_device_ms", "single_device_ms",
                "sync_ms", "pipelined_ms", "single_p50_ms", "single_p90_ms",
                "dispatch_floor_ms", "encode_texts_per_s",
                "encode_texts_per_s_device"):
        assert math.isfinite(metrics[key]) and metrics[key] > 0, key
    assert arrays["device"][1].shape == (bench.Q_BATCH, bench.K)
    for name in ("graph", "cpu", "golden"):
        np.testing.assert_array_equal(arrays["device"][1], arrays[name][1])
        np.testing.assert_allclose(arrays["device"][0], arrays[name][0],
                                   atol=TOL, rtol=0)

    # the JAX run's record for the same two rates, its device phases
    # replaced by the port's numbers
    def fake_main(m):
        m.update(dev_qps=metrics["dev_qps"], cpu_qps=metrics["cpu_qps"],
                 slope_ok=True)
        return m

    import legal_rag_tpu.utils.cache as jax_cache

    monkeypatch.setattr(jax_cache, "enable_compile_cache", lambda d: None)
    monkeypatch.setattr(jax_bench, "REPO", str(tmp_path))
    monkeypatch.setattr(jax_bench, "BANK_PATH", str(tmp_path / "bank.json"))
    monkeypatch.setattr(jax_bench, "_probe_relay", lambda: True)
    monkeypatch.setattr(jax_bench, "_install_handler", lambda: None)
    monkeypatch.setattr(jax_bench, "main", fake_main)
    jax_bench.run()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["metric"] == "hybrid_search_qps_per_chip_batch64"
    assert got["value"] > 0 and got["vs_baseline"] > 0


def test_bench_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert "is_available() is false" in capsys.readouterr().err
