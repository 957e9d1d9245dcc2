"""The port's quality gate and evaluation commands against the JAX
package's, on the CPU.

One store dir, built in-test by the JAX package from a corpus that
``ingest.synthetic.write_legal_corpus`` writes (five laws, 220 chunks)
with a small MiniLM (2 layers, hidden 64) and PQ, IVF and a token slab,
goes through both packages:

- ``validate_result`` on the JAX suite's cases;
- ``run_quality_eval`` with and without the paraphrase suite: each
  row's ``passed``, ``failures`` and ``detected_context`` equal;
- ``run_retrieval_gate`` with the serving and the CI floors: measured
  values within 1e-6, the same checks and ``gate_passed``;
- the provenance block: the same keys, ``platform == "cpu"`` and the
  store's fields equal;
- ``eval``, ``eval-gate`` and ``eval-retrieval`` (every flag of the JAX
  command line, plus ``--device cpu``) in a process where jax and the
  JAX package cannot load: exit codes equal to the JAX command line's
  and reports within 1e-6 (the latency and the device fields apart).

The JAX package's own quality tests build from the real corpus, which
this image lacks; the absolute CI floors hold here only where the JAX
package reaches them on the same store, so the tests assert agreement.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from legal_rag_tpu import quality as jquality
from legal_rag_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from legal_rag_tpu.config import EncoderConfig, RetrievalConfig, ShardingConfig
from legal_rag_tpu.config import FusionConfig as JaxFusion
from legal_rag_tpu.index.builder import build_index as jax_build
from legal_rag_tpu.index.store import VectorStore as JaxStore
from legal_rag_tpu.models.encoder import SentenceEncoder as JaxEncoder
from legal_rag_tpu.models.minilm import init_minilm_params as jax_init
from legal_rag_tpu.retrieval.engine import RetrievalEngine as JaxEngine
from legal_rag_tpu.retrieval.facade import LegalEngine as JaxLegal
from legal_rag_tpu_torch import quality
from legal_rag_tpu_torch.config import DEFAULT_CONFIG, FusionConfig
from legal_rag_tpu_torch.index.builder import _chunk_dicts
from legal_rag_tpu_torch.index.store import VectorStore
from legal_rag_tpu_torch.models.wordpiece import (
    WordPieceTokenizer, build_wordpiece_vocab,
)
from legal_rag_tpu_torch.retrieval.engine import RetrievalEngine
from legal_rag_tpu_torch.retrieval.facade import LegalEngine

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
CI_FLOORS = {   # tests/test_quality_cli.py's untrained floors
    "structure": {"mode": "rrf", "recall@10": 0.88},
    "sibling": {"mode": "rrf", "recall@10": 0.40},
}
# the fields of a report that name the device or time a run
DEVICE_FIELDS = ("platform", "device_kind", "n_devices")
# The MaxSim modes cast the query tokens to the slab's bf16 in both
# packages; fp32 token states ~1e-7 apart (another summation order) can
# round to neighbouring bf16 values (tests/test_torch_maxsim.py
# test_engine_mode_matches_jax_engine), which can move one near-tied
# query's rank. Their recall and MRR are held within one query's share,
# 1/n; every other mode within TOL.
MAXSIM = ("maxsim", "maxsim-rerank")


def build_eval_store(root: Path) -> Path:
    """A JAX-built store of the synthetic legal corpus (220 chunks): a
    2-layer, 64-wide MiniLM drawn by the JAX package, PQ m=8 with IVF
    cells of 32, a token slab of 8."""
    from legal_rag_tpu_torch.ingest import parse_corpus
    from legal_rag_tpu_torch.ingest.synthetic import write_legal_corpus

    write_legal_corpus(root / "docs", n_chunks=220, seed=7)
    chunks = _chunk_dicts(parse_corpus(root / "docs"))
    cfg = RetrievalConfig(
        encoder=EncoderConfig(vocab_size=1500, hidden=64, layers=2, heads=4,
                              intermediate=128, max_len=64, encode_batch=64),
        sharding=ShardingConfig(num_shards=1),
    )
    vocab = build_wordpiece_vocab([c["text"] for c in chunks], size=1500)
    enc_cfg = dataclasses.replace(cfg.encoder, vocab_size=len(vocab))
    params = _np_tree(jax_init(enc_cfg, seed=3))
    enc = JaxEncoder(cfg=enc_cfg, params=params,
                     tokenizer=WordPieceTokenizer(vocab),
                     prefer_tokenizer="python")
    jax_build(chunks, encoder=enc, config=cfg, store_dir=root / "store",
              pq_m=8, ivf_cell_size=32, multi_vector=8)
    return root / "store"


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.asarray(t)


def assert_close(got, want, path="", skip=()):
    """Nested reports equal, floats within TOL, keys in ``skip`` apart."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            if k not in skip:
                assert_close(got[k], want[k], f"{path}/{k}", skip)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, f"{path}[{i}]", skip)
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return build_eval_store(tmp_path_factory.mktemp("quality"))


@pytest.fixture(scope="module")
def engines(store_dir):
    """(JAX LegalEngine, port LegalEngine) on the store, RRF, no LLM, as
    ``run_quality_eval`` builds them."""
    jcfg = dataclasses.replace(JAX_DEFAULT, fusion=JaxFusion(mode="rrf"))
    tcfg = dataclasses.replace(DEFAULT_CONFIG, fusion=FusionConfig(mode="rrf"))
    return (JaxLegal(store_dir=store_dir, config=jcfg, use_llm=False),
            LegalEngine(store_dir=store_dir, config=tcfg, use_llm=False,
                        device="cpu"))


# -- validate_result ----------------------------------------------------

_OK = {"answer": "x" * 20, "sources": [{"law": "BNS"}], "disclaimer": "d"}
VALIDATE_CASES = [
    ({"response": {**_OK, "safety_alert": "call 112",
                   "immediate_action_plan": ["go to police"]}},
     "victim_distress", None),
    ({"response": dict(_OK)}, "victim_distress", None),
    ({"response": {**_OK, "answer": "x"}}, "informational", None),
    ({"response": {**_OK, "safety_alert": "no!"}}, "informational", None),
    ({"response": {**_OK, "safety_alert": "no!"}}, "any", None),
    ({"response": {}}, "informational", None),
    ({"response": dict(_OK), "context_used": [{"section_id": "BNS_309"}]},
     "informational", ("BNS_",)),
    ({"response": dict(_OK), "context_used": [{"section_id": "BNSS_58"},
                                              {"section_id": None}]},
     "any", ("BNS_304", "NALSA_")),
]


@pytest.mark.parametrize("case", range(len(VALIDATE_CASES)))
def test_validate_result_matches_jax(case):
    result, expected, grounding = VALIDATE_CASES[case]
    assert (quality.validate_result(result, expected, grounding)
            == jquality.validate_result(result, expected, grounding))


# -- run_quality_eval ---------------------------------------------------


@pytest.mark.parametrize("include_paraphrase", [False, True])
def test_quality_eval_matches_jax(engines, include_paraphrase):
    jeng, teng = engines
    ref = jquality.run_quality_eval(engine=jeng,
                                    include_paraphrase=include_paraphrase)
    got = quality.run_quality_eval(engine=teng,
                                   include_paraphrase=include_paraphrase)
    fields = ("query", "expected_context", "detected_context", "passed",
              "failures")
    suites = [("results", got["results"], ref["results"])]
    if include_paraphrase:
        assert {k: v for k, v in got["paraphrase"].items() if k != "results"} \
            == {k: v for k, v in ref["paraphrase"].items() if k != "results"}
        suites.append(("paraphrase", got["paraphrase"]["results"],
                       ref["paraphrase"]["results"]))
    else:
        assert "paraphrase" not in got
    for name, rows, want in suites:
        assert [{f: r[f] for f in fields} for r in rows] == \
            [{f: r[f] for f in fields} for r in want], name
    assert (got["total"], got["passed"], got["uses_llm"]) == \
        (ref["total"], ref["passed"], ref["uses_llm"])


def test_quality_eval_builds_its_engine_on_the_device(store_dir, tmp_path):
    """Without an engine the eval loads the store on ``device``, and its
    report, written to ``report_path``, says so."""
    report = quality.run_quality_eval(store_dir,
                                      report_path=tmp_path / "q.json",
                                      device="cpu")
    saved = json.loads((tmp_path / "q.json").read_text())
    assert saved["provenance"]["platform"] == "cpu"
    assert saved["passed"] == report["passed"]
    assert saved["provenance"]["fusion_mode"] == "rrf"


# -- run_retrieval_gate -------------------------------------------------


@pytest.mark.parametrize("floors", ["serving", "ci"])
def test_retrieval_gate_matches_jax(store_dir, floors):
    thresholds = None if floors == "serving" else CI_FLOORS
    jstore, tstore = JaxStore.load(store_dir), VectorStore.load(store_dir)
    ref = jquality.run_retrieval_gate(jstore, thresholds=thresholds,
                                      max_queries=120)
    got = quality.run_retrieval_gate(tstore, thresholds=thresholds,
                                     max_queries=120, device="cpu")
    assert_close(got["checks"], ref["checks"])
    assert_close(got["splits"], ref["splits"])
    assert got["gate_passed"] == ref["gate_passed"]
    assert got["n_queries"] == ref["n_queries"]
    # an absolute floor holds wherever the JAX package reaches it here
    for g, r in zip(got["checks"], ref["checks"]):
        if r["passed"]:
            assert g["measured"] >= g["threshold"], g


def test_provenance_matches_jax(store_dir):
    jstore, tstore = JaxStore.load(store_dir), VectorStore.load(store_dir)
    ref = jquality._provenance(JaxEngine(jstore))
    got = quality._provenance(RetrievalEngine(tstore, device="cpu"))
    assert list(got) == list(ref)
    assert got["platform"] == ref["platform"] == "cpu"
    assert got["device_kind"] == "cpu" and got["n_devices"] == 1
    assert {k: v for k, v in got.items() if k not in DEVICE_FIELDS} == \
        {k: v for k, v in ref.items() if k not in DEVICE_FIELDS}
    assert got["n_docs"] == tstore.n_docs
    assert len(got["corpus_hash"]) == 16
    assert got["multi_vector"] is True and got["cross_encoder"] is False


# -- the command line ---------------------------------------------------

_BLOCK = (
    "import sys\n"
    "for _name in ('jax', 'optax', 'legal_rag_tpu'):\n"
    "    sys.modules[_name] = None\n"
)

COMMANDS = {
    "eval": ["--include-paraphrase"],
    "eval-gate": ["--max-queries", "120"],
    "eval-retrieval": ["--include-pq", "--include-maxsim", "--max-pairs",
                       "80"],
}


def _run(code: str, env=None) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _cli_code(package: str, store_dir, out, device_flags) -> str:
    """Each command of ``package``'s command line over the store, its
    exit codes printed as a dict after ``RCS``."""
    return f"""
from {package}.cli import main
rcs = {{}}
for cmd, flags in {COMMANDS!r}.items():
    rcs[cmd] = main([cmd, "--store", {str(store_dir)!r}, "--report",
                     {str(out)!r} + "/{package}_" + cmd + ".json",
                     *{device_flags!r}, *flags])
print("RCS", rcs)
"""


@pytest.fixture(scope="module")
def cli_runs(store_dir, tmp_path_factory):
    """Each command through the JAX command line on one CPU device (the
    port's engine is one device; JAX's default engine shards over every
    device, and the dense-first MaxSim rerank takes its candidates a
    shard) and through the port's in a process where jax and the JAX
    package cannot load: ``{command: (jax rc, jax report, port rc, port
    report)}``."""
    out = tmp_path_factory.mktemp("cli")
    env = {**os.environ, "XLA_FLAGS": "", "JAX_PLATFORMS": "cpu"}
    jax_out = _run(_cli_code("legal_rag_tpu", store_dir, out, []), env=env)
    port_out = _run(_BLOCK + _cli_code(
        "legal_rag_tpu_torch", store_dir, out, ["--device", "cpu"]) + """
print("JAX_MODULES", sorted(m for m in sys.modules
      if m.split(".")[0] in ("jax", "optax", "legal_rag_tpu")
      and sys.modules[m] is not None))
""")
    assert "JAX_MODULES []" in port_out
    rcs = [ast.literal_eval(text.split("RCS ", 1)[1].splitlines()[0])
           for text in (jax_out, port_out)]
    return {cmd: tuple(x for pkg, rc in zip(
        ("legal_rag_tpu", "legal_rag_tpu_torch"), rcs) for x in (
        rc[cmd], json.loads((out / f"{pkg}_{cmd}.json").read_text())))
        for cmd in COMMANDS}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_cli_matches_jax_without_jax(cli_runs, cmd):
    jrc, jrep, trc, trep = cli_runs[cmd]
    assert trc == jrc
    assert trep["provenance"]["platform"] == "cpu"
    assert_close(trep, jrep, skip=("latency_s", *DEVICE_FIELDS, *MAXSIM))
    if cmd == "eval-retrieval":
        for split in ("structure", "paraphrase"):
            n = jrep[split]["n_queries"]
            for mode in MAXSIM:
                got, want = (r[split]["modes"][mode] for r in (trep, jrep))
                assert got.keys() == want.keys()
                for metric, value in want.items():
                    assert abs(got[metric] - value) <= 1 / n + TOL, (
                        split, mode, metric, got[metric], value)
    if cmd == "eval":
        ok = trep["passed"] == trep["total"] and trep["paraphrase"][
            "gate_passed"]
        assert trc == (0 if ok else 1)
    elif cmd == "eval-gate":
        assert trc == (0 if trep["gate_passed"] else 1)
    else:
        assert set(trep) == {"structure", "paraphrase", "provenance"}
        assert {"pq", "maxsim", "maxsim-rerank"} <= set(
            trep["structure"]["modes"])
        assert "pq" not in trep["paraphrase"]["modes"]


def test_eval_retrieval_rerank_and_ablation_flags(store_dir, tmp_path,
                                                  monkeypatch):
    """``--rerank-steps`` trains a cross-encoder for the run and reports
    base against reranked; ``--finetune-steps`` hands the store's chunks,
    the steps, ``--max-pairs`` and ``--device`` to ``compare_encoders``."""
    from legal_rag_tpu_torch import cli, evaluation

    report = tmp_path / "rerank.json"
    assert cli.main(["eval-retrieval", "--store", str(store_dir),
                     "--rerank-steps", "2", "--max-pairs", "20",
                     "--device", "cpu", "--report", str(report)]) == 0
    got = json.loads(report.read_text())
    assert got["base_mode"] == "rrf" and got["n_queries"] == 20
    assert {"base", "reranked"} <= set(got["modes"])

    seen = {}

    def fake(chunks, **kw):
        seen.update(kw, n_chunks=len(chunks))
        return {"random_encoder": {}, "finetuned_encoder": {}}

    monkeypatch.setattr(evaluation, "compare_encoders", fake)
    assert cli.main(["eval-retrieval", "--store", str(store_dir),
                     "--finetune-steps", "3", "--max-pairs", "7",
                     "--device", "cpu"]) == 0
    assert seen["finetune_steps"] == 3 and seen["max_pairs"] == 7
    assert seen["device"] == "cpu"
    assert seen["n_chunks"] == VectorStore.load(store_dir).n_docs


def test_eval_writes_its_default_report_under_build(store_dir, tmp_path,
                                                    monkeypatch):
    """``eval`` without ``--report`` writes build/quality_report.json
    (made if missing), never the repository's quality_report.json."""
    from legal_rag_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["eval", "--store", str(store_dir), "--device", "cpu"])
    saved = json.loads((tmp_path / "build" / "quality_report.json")
                       .read_text())
    assert rc == (0 if saved["passed"] == saved["total"] else 1)
    assert not (tmp_path / "quality_report.json").exists()
