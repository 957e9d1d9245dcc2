"""The ``legal-1m.query-open`` cell: its configuration and cell as the
manifest names them, the postings cut's reader on a stub context, and a
run of the cell on the CPU at a small store whose postings cap the
function words pass, so that the served cut runs and the comparison
with the reference judges it."""

import copy

import pytest

from benchmark import harness
from benchmark.harness import LayerContext

CELL = "legal-1m.query-open"


def test_manifest_names_the_configuration_and_the_cell():
    manifest, wl, config, mix = harness.cell(CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        ("legal-1m-query", "query-open", 1)
    entry = next(c for c in manifest["configs"]
                 if c["name"] == "legal-1m-query")
    assert entry["file"] == "benchmark/configs/legal-1m-query.json"
    assert entry["reduced"] == [] and config["reduced"] == []
    # the legal-1m store as it is; only what the deployment says differs
    store = harness.load_json(harness.HERE / "configs" / "legal-1m.json")
    for key in ("name", "deployment"):
        assert config.pop(key) != store.pop(key)
    assert config["assumed"].pop("ce_alpha") != store["assumed"].pop("ce_alpha")
    assert config == store
    assert config["retrieval"]["bm25"]["postings_cap"] == 1 << 17
    assert config["cross_encoder"]["candidates"] == 16
    assert (mix["entry"], mix["rate_qps"], mix["warm_s"]) == ("query", 8.0, 6.0)
    reported = {m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert {"setup_s", "query_p50_ms", "postings_ms.query",
            "graph_fill_ms.query", "postings_cut_ms.query"} <= reported


def test_postings_cut_reader():
    read = harness.reader("postings_cut_ms.query")
    ctx = LayerContext(stages={"postings": {"count": 6, "total_s": 0.03},
                               "postings_cut": {"count": 4, "total_s": 0.01}})
    assert read(ctx) == pytest.approx(2.5)
    # a program without the span, or a window that cut nothing: nothing
    assert read(LayerContext(stages={"postings": {"count": 6,
                                                  "total_s": 0.03}})) is None
    assert read(LayerContext(stages={"postings_cut": {"count": 0,
                                                      "total_s": 0.0}})) is None


def test_cell_runs_correct_with_the_cut_at_a_small_store():
    _, _, config, _ = harness.cell(CELL)
    retrieval = copy.deepcopy(config["retrieval"])
    # a cap that the function words of 3,000 docs pass
    retrieval["bm25"]["postings_cap"] = 256
    engines = []
    res = harness.run_cell(
        CELL, 3000000041, 3.0, False, device="cpu",
        overrides={"n_docs": 3000, "vocab_size": 4000,
                   "retrieval": retrieval},
        mix_overrides={"rate_qps": 2.0, "judged": 8, "warm_s": 1.0},
        mutate=lambda eng, ret: engines.append(ret))
    assert res["correct"], res["checks"]
    counters = engines[0].postings_counters()
    assert counters["truncated"] > 0, counters
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "query_p50_ms"}
