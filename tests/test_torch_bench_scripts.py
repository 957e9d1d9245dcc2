"""The port's two benches against the JAX package's scripts, on the CPU
at a small size:

- ``bench_hybrid_scale.run(device="cpu")`` at N=4,096 docs with the
  postings cap lowered to 1,024 (so that it truncates, as the real cap
  does at 1M docs): the CSR, the queries, the float64 golden and the
  capped sparse recall equal the JAX script's exactly; each budget's
  hybrid top-10 equals the JAX ``sharded_hybrid_search`` on one CPU
  device within 1e-5 (fp32 dot products of bf16 docs in another order;
  BM25 sums likewise), ids under the tie-aware rule.
- ``bench_http.run(device="cpu")``: one coalesced pass, 2 requests a
  client at concurrency 1 and 2, over a tiny store built here; zero
  errors and the JAX report's keys. Its query list and client loop are
  the JAX script's.
- Both ``main()``s refuse to run without a card.
"""

import importlib.util
import inspect
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from legal_rag_tpu_torch.scripts import bench_http, bench_hybrid_scale

REPO_ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = REPO_ROOT / "scripts"
N_SMALL, CAP_SMALL = 4096, 1024
TOL = 1e-5


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def hybrid():
    """The port's run at the small size, and the JAX script's module
    set to the same N."""
    jax_mod = jax_script("bench_hybrid_scale")
    jax_mod.N = N_SMALL
    port_cap = bench_hybrid_scale.CAP
    bench_hybrid_scale.CAP = CAP_SMALL
    try:
        out = bench_hybrid_scale.run(N_SMALL, device="cpu",
                                     log=lambda s: None)
    finally:
        bench_hybrid_scale.CAP = port_cap
    return out, jax_mod


def _jax_data(jax_mod):
    """The JAX script's draws, in its order: index, queries, docs and
    query embeddings."""
    rng = np.random.default_rng(0)
    index = jax_mod.synth_index(rng)
    queries = []
    for _ in range(jax_mod.Q):
        head = rng.integers(0, 8, 2)
        tail = rng.integers(100, jax_mod.V, 10)
        queries.append(" ".join(f"t{t}" for t in np.r_[head, tail]))
    docs, q_emb = bench_hybrid_scale.make_embeddings(rng, N_SMALL)
    return index, queries, docs, q_emb


def test_hybrid_scale_host_numbers_equal_the_jax_script(hybrid):
    out, jax_mod = hybrid
    index, queries, _, _ = _jax_data(jax_mod)
    got = out["index"]
    for field in ("indptr", "doc_ids", "weights", "idf", "doc_len"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(index, field))
    assert got.vocab == index.vocab and got.n_docs == index.n_docs == N_SMALL
    assert out["queries"] == queries
    gold = jax_mod.golden_sparse_topk(index, queries, jax_mod.K)
    np.testing.assert_array_equal(out["golden"], gold)
    budget = index.postings_budget(queries, cap=CAP_SMALL)
    assert out["budgets"] == {"capped": budget,
                              "uncapped": index.postings_budget(queries)}
    assert budget < out["budgets"]["uncapped"]      # the cap truncates

    import jax.numpy as jnp
    from legal_rag_tpu.ops.sparse import bm25_topk as jax_bm25_topk

    pid, pw = index.gather_postings(queries, budget)
    _, top = jax_bm25_topk(jnp.asarray(pid), jnp.asarray(pw), N_SMALL,
                           jax_mod.K)
    top = np.asarray(top)
    want = np.mean([len(set(top[i]) & set(gold[i])) / jax_mod.K
                    for i in range(jax_mod.Q)])
    assert out["sparse_recall"] == want
    assert out["hybrid_ms"] == {"capped": None, "uncapped": None}
    assert out["k1_launches"] == 0          # the plain version on the CPU


@pytest.mark.parametrize("budget", ["capped", "uncapped"])
def test_hybrid_scale_search_matches_jax_sharded_hybrid(hybrid, budget):
    import jax.numpy as jnp
    from legal_rag_tpu.parallel.mesh import make_mesh
    from legal_rag_tpu.parallel.sharded import (
        ShardedIndex, sharded_hybrid_search,
    )

    out, jax_mod = hybrid
    index, queries, docs, q_emb = _jax_data(jax_mod)
    pid, pw = index.gather_postings(queries, out["budgets"][budget])
    mesh = make_mesh(1)
    sidx = ShardedIndex.from_embeddings(docs, mesh, dtype="bfloat16")
    ref_f, ref_i, _, _ = sharded_hybrid_search(
        sidx.docs, jnp.asarray(pid), jnp.asarray(pw), jnp.asarray(q_emb),
        jnp.full((jax_mod.Q,), 0.5, jnp.float32), mesh=mesh, k=jax_mod.K,
        c=2 * jax_mod.K, n_docs=N_SMALL, mode="weighted",
    )
    ref_f, ref_i = np.asarray(ref_f), np.asarray(ref_i)
    got_f, got_i = out["hybrid"][budget]
    np.testing.assert_allclose(got_f, ref_f, atol=TOL, rtol=0)
    band = ref_f[:, -1:] + TOL      # above it no doc can be tied out
    for r in range(ref_f.shape[0]):
        assert set(got_i[r][got_f[r] > band[r]]) <= set(ref_i[r])
        assert set(ref_i[r][ref_f[r] > band[r]]) <= set(got_i[r])
    if budget == "uncapped":
        overlap = np.mean([len(set(a) & set(b)) / jax_mod.K for a, b in zip(
            out["hybrid"]["capped"][1], got_i)])
        assert out["overlap"] == overlap


def test_bench_http_is_the_jax_scripts_client():
    jax_mod = jax_script("bench_http")
    assert bench_http.QUERIES == jax_mod.QUERIES
    for name in ("client_loop", "run_level"):
        assert inspect.getsource(getattr(bench_http, name)) == \
            inspect.getsource(getattr(jax_mod, name))


@pytest.fixture(scope="module")
def tiny_store(tmp_path_factory):
    from legal_rag_tpu_torch.config import (
        EncoderConfig, RetrievalConfig, ShardingConfig,
    )
    from legal_rag_tpu_torch.index.builder import _chunk_dicts, build_index
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    root = tmp_path_factory.mktemp("http_store")
    write_legal_corpus(root / "docs", n_chunks=120, seed=5)
    cfg = RetrievalConfig(
        encoder=EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                              intermediate=128, max_len=64),
        sharding=ShardingConfig(num_shards=1),
    )
    build_index(_chunk_dicts(parse_corpus(root / "docs")), config=cfg,
                store_dir=root / "store", device="cpu")
    return str(root / "store")


def test_bench_http_cpu_pass(tiny_store, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    report = bench_http.run(tiny_store, port=port, requests=2, levels=(1, 2),
                            device="cpu", log=lambda s: None,
                            server_log=str(tmp_path / "serve.log"))
    assert set(report) == {"store", "passes", "provenance"}
    assert list(report["passes"]) == ["coalesced"]
    rows = report["passes"]["coalesced"]
    assert [r["concurrency"] for r in rows] == [1, 2]
    for r in rows:
        assert r["n_errors"] == 0, r.get("error_sample")
        assert r["n_requests"] == 2 * r["concurrency"]
        assert set(r) == {"concurrency", "n_requests", "n_errors", "p50_ms",
                          "p90_ms", "p99_ms", "mean_ms", "qps"}
        assert 0 < r["p50_ms"] <= r["p99_ms"]
    assert report["provenance"] == {"platform": "cpu", "device_kind": "cpu",
                                    "n_devices": 1}


def test_bench_mains_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_hybrid_scale.main() == 1
    assert bench_http.main(["--store", "unused"]) == 1
    assert "is_available() is false" in capsys.readouterr().err
