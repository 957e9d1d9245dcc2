"""The port's copies of pure-host code stay verbatim copies of the JAX
package's: for each copied module or object, its source with
``legal_rag_tpu_torch`` read as ``legal_rag_tpu`` equals the
original's. An edit on either side fails here until both agree."""

import importlib
import inspect
import re

import pytest

COPIED_MODULES = [
    "config",
    "server",
    "server.app",
    "server.batching",
    "server.adapter",
    "server.answer_units",
    "server.schemas",
    "server.sentence_attribution",
    "server.source_fetcher",
    "ingest",
    "ingest.parser",
    "ingest.pipeline",
    "models.wordpiece",
    "retrieval.llm",
    "retrieval.classifier",
    "retrieval.query_form",
    "retrieval.responder",
    "retrieval.orchestrator",
    "index.store",
]

COPIED_OBJECTS = [
    "ops.sparse:tokenize",
    "ops.sparse:BM25Index",
    "ops.sparse:build_bm25",
    "models.convert:save_params_npz",
    "models.convert:load_params_npz",
    "models.cross_encoder:blend_scores",
    "models.cross_encoder:ce_policy_alpha",
    "models.cross_encoder:CrossEncoder.encode_pairs",
    "models.cross_encoder:CrossEncoder.rerank",
    "retrieval.engine:SearchResult",
    "retrieval.engine:_pad_pow2",
    "retrieval.engine:RetrievalEngine.enable_request_coalescing",
    "retrieval.engine:RetrievalEngine.search_batch",
    "retrieval.engine:RetrievalEngine._assemble_results",
    "retrieval.engine:RetrievalEngine.search",
    "retrieval.facade:LegalEngine.query",
    "retrieval.facade:LegalEngine._adapted_view",
    "ops.dense:exact_rescore",
    "ops.pq:PQCodebook",
    "ops.pq:unpack_codes",
    "ops.pq:decode_pq",
    "ops.pq:IVFIndex",
    "models.convert:convert_hf_bert",
    "models.convert:_dense",
    "models.convert:_ln",
    "models.finetune:augment_query",
    "models.finetune:make_pairs",
    "models.finetune:section_groups",
    "models.finetune:make_sibling_pairs",
    "models.cross_encoder:make_hard_negative_miner",
    "evaluation:labeled_pairs_from_chunks",
    "evaluation:paraphrase_pairs_from_chunks",
    "evaluation:sibling_span_pairs_from_chunks",
    "evaluation:recall_at_k",
    "evaluation:mrr_at_k",
    "index.builder:_chunk_dicts",
    "quality:validate_result",
]

# copied as they are so that both packages dispatch at the same sizes
COPIED_CONSTANTS = [
    "ops.dense:TWOPHASE_MIN_DOCS",
    "ops.dense:TWOPHASE_BLOCK_N",
    "ops.dense:TWOPHASE_SEG_ROWS",
    "ops.dense:LARGE_N_THRESHOLD",
    "ops.dense:_SCORE_MATRIX_BUDGET_BYTES",
    "ops.dense:_TIE_OVERSAMPLE",
    "models.cross_encoder:HEADING_MAX_WORDS",
    "ops.pq:_NEG_F32",
    "models.finetune:SIBLING_PROB_DEFAULT",
    "models.finetune:REGISTER_FORMS",
    "models.finetune:AUGMENT_KINDS_DEFAULT",
    "evaluation:_SOP_PREFIX",
    "quality:QUALITY_SUITE",
    "quality:PARAPHRASE_SUITE",
    "quality:PARAPHRASE_PASS_THRESHOLD",
    "quality:RETRIEVAL_GATE_THRESHOLDS",
]

# copies that build an engine and take the port's ``device`` for it:
# each (port text, reference text) pair maps the port's source back to
# the reference's, and what is left must be verbatim
ADAPTED_OBJECTS = {
    "quality:run_retrieval_gate": (
        ('    device="cuda",\n', ""),
        (" Without\n    ``engine`` the gate builds one on ``device``.", ""),
        ("RetrievalEngine(store, device=device)", "RetrievalEngine(store)"),
    ),
    "quality:run_quality_eval": (
        ('    device="cuda",\n', ""),
        ("\n\n    The JAX package's function but for ``device``: without "
         "``engine``\n    the ``LegalEngine`` is built on it (the one line "
         "that differs).", ""),
        ("config=cfg, device=device)", "config=cfg)"),
    ),
}


def _resolve(package, spec):
    mod_name, _, attr = spec.partition(":")
    obj = importlib.import_module(f"{package}.{mod_name}")
    for part in filter(None, attr.split(".")):
        obj = getattr(obj, part)
    return obj


def _as_reference(src: str) -> str:
    return src.replace("legal_rag_tpu_torch", "legal_rag_tpu")


# comments that name the port's devices where the reference names JAX's:
# (port text, reference text), mapped back before the comparison
COPY_COMMENTS = {
    "config": (("# None = every visible CUDA card",
                "# None = len(jax.devices())"),),
}


@pytest.mark.parametrize("spec", COPIED_MODULES + COPIED_OBJECTS)
def test_copy_is_verbatim(spec):
    port = inspect.getsource(_resolve("legal_rag_tpu_torch", spec))
    ref = inspect.getsource(_resolve("legal_rag_tpu", spec))
    for ours, theirs in COPY_COMMENTS.get(spec, ()):
        assert port.count(ours) == 1, ours
        port = port.replace(ours, theirs)
    assert _as_reference(port) == ref


@pytest.mark.parametrize("spec", sorted(ADAPTED_OBJECTS))
def test_adapted_copy_differs_only_by_device(spec):
    port = _as_reference(inspect.getsource(_resolve("legal_rag_tpu_torch",
                                                    spec)))
    for got, want in ADAPTED_OBJECTS[spec]:
        assert got in port, got
        port = port.replace(got, want)
    assert port == inspect.getsource(_resolve("legal_rag_tpu", spec))


@pytest.mark.parametrize("spec", COPIED_CONSTANTS)
def test_copied_constant_matches(spec):
    assert _resolve("legal_rag_tpu_torch", spec) == _resolve("legal_rag_tpu", spec)


def _without_profiler_lines(src: str):
    return [ln for ln in src.splitlines()
            if not re.search(r"profiler|trace", ln, re.I)]


def test_stage_timer_is_a_copy_apart_from_its_profiler_lines():
    """``utils.timing.StageTimer`` equals the JAX package's but for the
    lines that name the profiler (torch's record_function in place of
    jax's TraceAnnotation); ``device_trace`` is the port's own, tested in
    tests/test_torch_timing.py."""
    from legal_rag_tpu.utils import timing as ref
    from legal_rag_tpu_torch.utils import timing as port

    port_src = inspect.getsource(port.StageTimer)
    ref_src = inspect.getsource(ref.StageTimer)
    assert port_src != ref_src
    assert _without_profiler_lines(port_src) == _without_profiler_lines(ref_src)
    assert "jax" not in inspect.getsource(port)


def test_copies_rewrite_only_import_lines():
    """Within the copied modules, every line that differs from the
    original is an import of the port in place of the JAX package (or
    a comment of COPY_COMMENTS)."""
    for name in COPIED_MODULES:
        src = inspect.getsource(
            importlib.import_module(f"legal_rag_tpu_torch.{name}"))
        for ours, theirs in COPY_COMMENTS.get(name, ()):
            src = src.replace(ours, theirs)
        port = src.splitlines()
        ref = inspect.getsource(
            importlib.import_module(f"legal_rag_tpu.{name}")
        ).splitlines()
        for a, b in zip(port, ref):
            if a != b:
                assert a.lstrip().startswith(("from ", "import ")), a


@pytest.mark.parametrize("name", ["sample_queries", "cpu_baseline"])
def test_bench_copy_is_verbatim(name):
    """The headline bench's host functions are the repository root
    ``bench.py``'s (the JAX package's harness), loaded from its file."""
    import importlib.util
    from pathlib import Path

    from legal_rag_tpu_torch import bench

    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("jax_bench_copy", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert inspect.getsource(getattr(bench, name)) == \
        inspect.getsource(getattr(ref, name))
    assert (bench.Q_BATCH, bench.K, bench.REPEATS) == \
        (ref.Q_BATCH, ref.K, ref.REPEATS)


@pytest.mark.parametrize("name", ["wordpiece.cpp", "unicode_tables.h",
                                  "gen_unicode_tables.py"])
def test_native_tokenizer_source_is_a_verbatim_copy(name):
    """The C++ tokenizer the port builds (``native_ext``) is the JAX
    package's source, byte for byte."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    port = (root / "legal_rag_tpu_torch" / "native" / name).read_bytes()
    assert port == (root / "legal_rag_tpu" / "native" / name).read_bytes()
