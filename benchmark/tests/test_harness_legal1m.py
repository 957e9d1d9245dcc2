"""The ``legal-1m`` cell on the CPU at a small store: the witness over a
store past the segment sums' threshold, a run of the cell that comes
out correct, and the new readers (K1's roofline share, the input
staging's span) by hand and on a program without what they read."""

import types

import pytest

from benchmark import harness, witness
from benchmark.harness import BatchWork, LayerContext
from benchmark.layers import counting
from benchmark.layers.k1_bytes import k1_bytes, k1_least_seconds

LARGE = dict(n_docs=70_000)        # past LARGE_N_THRESHOLD: auto takes segsum


def test_witness_past_the_threshold_reads_rounding_on_both_paths():
    """Queries of 3-8 consecutive words of a stored chunk, function words
    among them, so a row's postings run to tens of thousands and their
    running sum past 10**5, where float32's step is 0.008."""
    config = harness.load_json(harness.HERE / "configs" / "legal-1m.json")
    config.update(LARGE)
    mix = harness.load_json(harness.HERE / "traffic" / "search64.json")
    mix.update(batch=16)
    out = witness.witness(config, mix, 3000000011, 2, whole=2,
                          paths=("segsum", "scatter"), device="cpu")
    assert out["queries"] == 32 and out["whole_batches"] == 2
    for path in ("segsum", "scatter"):
        assert sum(n for _, n in out["bands"][path]) == 32
        assert all(b <= witness.ROUNDING for b, _ in out["bands"][path]), \
            out["bands"][path]
    assert out["ids_differ"] == 0 and not out["wide"]


SMALL = {
    "legal-1m.search64-rare": dict(
        overrides={"n_docs": 3000, "vocab_size": 4000},
        mix_overrides={"distinct_batches": 3, "batch": 16, "judged": 3,
                       "queries": {"kind": "rare_terms", "min_terms": 2,
                                   "max_terms": 5, "rank_lo": 100,
                                   "rank_hi": 4000}},
        seconds=1.0),
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_cell_runs_correct_at_a_small_store(workload):
    small = SMALL[workload]
    res = harness.run_cell(workload, 41, small["seconds"], False,
                           device="cpu", overrides=small["overrides"],
                           mix_overrides=small["mix_overrides"])
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "search_qps"}


def test_k1_bytes_by_hand():
    # 64 real queries over 1,000 docs of width 4: fp32 docs, then bf16
    assert k1_bytes(64, 1000, 4, 4) == 16_000 + 1024
    assert k1_bytes(64, 1000, 4, 2) == 8_000 + 1024
    assert k1_least_seconds(3, 10 ** 6, 384, 4) == \
        (1_536_000_000 + 4608) / counting.HBM_BYTES_PER_S


def _trace(ops):
    return types.SimpleNamespace(device_ops=ops, kernel_span={},
                                 busy_s=0.0, stretch_s=1.0)


def test_k1_roofline_reads_the_segmax_kernels_only():
    read = harness.reader("k1_roofline.search")
    batches = [BatchWork(q_real=64, k=5, postings=10, token_lengths=[8]),
               BatchWork(q_real=60, k=5, postings=10, token_lengths=[8])]
    least = (k1_least_seconds(64, 10 ** 6, 384, 4)
             + k1_least_seconds(60, 10 ** 6, 384, 4))
    ops = [{"cat": "kernel", "name": "void segmax_rm_tc_kernel<float>(...)",
            "dur": 1300.0},
           {"cat": "kernel", "name": "void segmax_rm_tc_kernel<float>(...)",
            "dur": 1400.0},
           {"cat": "kernel", "name": "sm80_xmma_gemm_f32f32", "dur": 900.0},
           {"cat": "gpu_memcpy", "name": "Memcpy HtoD segmax_rm", "dur": 50.0}]
    ctx = LayerContext(trace=_trace(ops), traced_batches=batches,
                       n_docs=10 ** 6, dim=384, doc_bytes=4)
    assert read(ctx) == pytest.approx(100.0 * least / 2.7e-3, rel=1e-12)
    # a stretch with no K1 (a store below the two-phase threshold), no
    # trace, no traced batch: nothing
    ctx.trace = _trace(ops[2:])
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None
    ctx.trace, ctx.traced_batches = _trace(ops), []
    assert read(ctx) is None


@pytest.mark.parametrize("metric", ["graph_fill_ms.search",
                                    "postings_ms.search"])
def test_span_readers(metric):
    span = "postings" if metric.startswith("postings") else "graph_fill"
    read = harness.reader(metric)
    ctx = LayerContext(stages={span: {"count": 4, "total_s": 0.01}})
    assert read(ctx) == pytest.approx(2.5)
    # a program without the span (the parent of graph_fill) reads nothing
    assert read(LayerContext(stages={"encode": {"count": 4,
                                                "total_s": 0.01}})) is None
