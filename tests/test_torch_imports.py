"""The PyTorch port stands alone: every module loads in a process where
``jax``, ``optax`` and the JAX package (``legal_rag_tpu``) cannot be
imported, no source line of the port imports them, the HTTP server
answers a query with them blocked, and every entry point runs on the
card unless the caller asks for the CPU."""

import inspect
import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import legal_rag_tpu_torch

PORT_DIR = Path(legal_rag_tpu_torch.__file__).parent
REPO_ROOT = PORT_DIR.parent

_BLOCK = (
    "import sys\n"
    "for _name in ('jax', 'optax', 'legal_rag_tpu'):\n"
    "    sys.modules[_name] = None\n"
)

_IMPORT_ALL = _BLOCK + """
import importlib, pkgutil
import legal_rag_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    legal_rag_tpu_torch.__path__, "legal_rag_tpu_torch.")
    if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
print(len(names))
print(" ".join(names))
"""

# the modules of the quantized tiers, the store module whose ivf_index()
# imports one of them lazily, the column-major kernels, the bench, the
# port's own copies of the JAX package's host modules, and the build
# path (training, evaluation, the builder, the command line)
NAMED_MODULES = [
    "legal_rag_tpu_torch.ops.pq",
    "legal_rag_tpu_torch.ops.pq_segmax",
    "legal_rag_tpu_torch.ops.segmax_rm",
    "legal_rag_tpu_torch.index.store",
    "legal_rag_tpu_torch.ops.segmax_cm",
    "legal_rag_tpu_torch.ops.fused_topk",
    "legal_rag_tpu_torch.ops.argmax_probe",
    "legal_rag_tpu_torch.scripts.bench_scale",
    "legal_rag_tpu_torch.ops.maxsim",
    "legal_rag_tpu_torch.scripts.bench_maxsim_scale",
    "legal_rag_tpu_torch.config",
    "legal_rag_tpu_torch.utils.timing",
    "legal_rag_tpu_torch.server.app",
    "legal_rag_tpu_torch.server.batching",
    "legal_rag_tpu_torch.server.adapter",
    "legal_rag_tpu_torch.server.schemas",
    "legal_rag_tpu_torch.server.sentence_attribution",
    "legal_rag_tpu_torch.server.source_fetcher",
    "legal_rag_tpu_torch.ingest",
    "legal_rag_tpu_torch.ingest.parser",
    "legal_rag_tpu_torch.ingest.pipeline",
    "legal_rag_tpu_torch.ingest.synthetic",
    "legal_rag_tpu_torch.models.train",
    "legal_rag_tpu_torch.models.finetune",
    "legal_rag_tpu_torch.models.cross_encoder",
    "legal_rag_tpu_torch.evaluation",
    "legal_rag_tpu_torch.index.builder",
    "legal_rag_tpu_torch.scripts.train_reranker",
    "legal_rag_tpu_torch.cli",
]


def _port_modules():
    return [
        m.name for m in pkgutil.walk_packages(
            legal_rag_tpu_torch.__path__, "legal_rag_tpu_torch."
        )
        if not m.name.endswith("__main__")
    ]


def test_every_port_module_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()
    assert int(count) == len(_port_modules()) >= 40
    assert set(NAMED_MODULES) <= set(names.split())


def test_store_ivf_index_resolves_with_jax_blocked():
    """``VectorStore.ivf_index()`` imports ``ops.pq`` when called; that
    import works in a process without jax."""
    code = _BLOCK + (
        "import numpy as np\n"
        "from legal_rag_tpu_torch.index.store import VectorStore\n"
        "s = VectorStore(embeddings=np.zeros((3, 4), np.float32), bm25=None,\n"
        "    chunks=[], pq_codes=np.arange(6, dtype=np.uint8).reshape(3, 2),\n"
        "    ivf_centroids=np.ones((2, 4), np.float32),\n"
        "    ivf_doc_ids=np.array([2, 0, 1, -1], np.int32), ivf_cell_size=2)\n"
        "ivf = s.ivf_index()\n"
        "print(type(ivf).__module__, ivf.codes.tolist(), ivf.n_pad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "legal_rag_tpu_torch.ops.pq", "[[4,", "5],", "[0,", "1],", "[2,",
        "3],", "[0,", "0]]", "1",
    ]


def _offenders(pattern: str):
    pattern = re.compile(pattern, re.M)
    return [
        str(p.relative_to(REPO_ROOT))
        for p in PORT_DIR.rglob("*.py")
        if pattern.search(p.read_text())
    ]


def test_no_port_source_imports_jax_or_optax():
    assert _offenders(r"^\s*(import|from)\s+(jax|optax)\b") == []


def test_no_port_source_imports_the_jax_package():
    assert _offenders(r"^\s*(import|from)\s+legal_rag_tpu\b(?!_torch)") == []


_SERVE_ONE = _BLOCK + """
import json, urllib.request
from legal_rag_tpu_torch.cli import BackgroundServer
from legal_rag_tpu_torch.index.synthetic import synthesize_store
from legal_rag_tpu_torch.retrieval.facade import LegalEngine

query = "What is the procedure to file an FIR?"
store = synthesize_store(1000, seed=3, planted=[query], device="cpu")
legal = LegalEngine(store=store, use_llm=False, device="cpu")
server = BackgroundServer(legal)
try:
    req = urllib.request.Request(
        server.url + "/api/v1/query", data=json.dumps({"query": query}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        status, body = r.status, json.loads(r.read())
finally:
    server.stop()
print(json.dumps({
    "status": status, "keys": sorted(body),
    "cites": [c["citation"] for c in body["context_used"]],
    "server": "legal_rag_tpu_torch.server.app" in sys.modules,
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "legal_rag_tpu"
                          and sys.modules[m] is not None),
}))
"""


def test_port_server_answers_a_query_with_the_jax_package_blocked():
    """``/api/v1/query`` through the port's own ``server.app.run_server``
    on the CPU, in a process where jax and the JAX package cannot be
    imported."""
    out = subprocess.run(
        [sys.executable, "-c", _SERVE_ONE], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == 200 and got["server"]
    assert {"answer", "sources", "context_used", "adapted"} <= set(got["keys"])
    assert "PLANTED 0" in got["cites"]
    assert got["jax_package"] == []


def _entry_points():
    from legal_rag_tpu_torch.index.synthetic import synthesize_store
    from legal_rag_tpu_torch.models.encoder import SentenceEncoder
    from legal_rag_tpu_torch.ops import pq
    from legal_rag_tpu_torch.ops.maxsim import MultiVectorIndex
    from legal_rag_tpu_torch.parallel.sharded import (
        ShardedIndex, ShardedMultiVectorIndex,
    )
    from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine
    from legal_rag_tpu_torch.retrieval.facade import LegalEngine
    from legal_rag_tpu_torch import evaluation
    from legal_rag_tpu_torch.index.builder import build_index
    from legal_rag_tpu_torch.scripts import bench_maxsim_scale

    return {
        "RetrievalEngine": RetrievalEngine, "LegalEngine": LegalEngine,
        "SentenceEncoder": SentenceEncoder,
        "ShardedIndex.from_pq_ivf": ShardedIndex.from_pq_ivf,
        "ShardedIndex.from_pq": ShardedIndex.from_pq,
        "ShardedIndex.from_embeddings": ShardedIndex.from_embeddings,
        "synthesize_store": synthesize_store,
        "_train_pq_sample": pq._train_pq_sample, "train_pq": pq.train_pq,
        "encode_pq": pq.encode_pq, "build_ivf": pq.build_ivf,
        "MultiVectorIndex.from_token_embeddings":
            MultiVectorIndex.from_token_embeddings,
        "ShardedMultiVectorIndex.from_arrays":
            ShardedMultiVectorIndex.from_arrays,
        "bench_maxsim_scale.run": bench_maxsim_scale.run,
        "build_index": build_index,
        "evaluate_store": evaluation.evaluate_store,
        "evaluate_rerank": evaluation.evaluate_rerank,
        "compare_encoders": evaluation.compare_encoders,
        "_bm25_ranked_ids": evaluation._bm25_ranked_ids,
    }


@pytest.mark.parametrize("name", [
    "RetrievalEngine", "LegalEngine", "SentenceEncoder",
    "ShardedIndex.from_pq_ivf", "ShardedIndex.from_pq",
    "ShardedIndex.from_embeddings", "synthesize_store", "_train_pq_sample",
    "train_pq", "encode_pq", "build_ivf",
    "MultiVectorIndex.from_token_embeddings",
    "ShardedMultiVectorIndex.from_arrays", "bench_maxsim_scale.run",
    "build_index", "evaluate_store", "evaluate_rerank", "compare_encoders",
    "_bm25_ranked_ids",
])
def test_entry_point_defaults_to_the_card(name):
    """A missing card fails loudly; the work never moves to the CPU
    unless the caller says ``device="cpu"``."""
    params = inspect.signature(_entry_points()[name]).parameters
    assert params["device"].default == "cuda"


def test_chip_smoke_imports_nothing_of_jax():
    """The smoke script reaches the JAX package only through the port."""
    src = (REPO_ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|optax)\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+legal_rag_tpu\b(?!_torch)", src, re.M)
