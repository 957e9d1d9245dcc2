"""A run with the timed path broken underneath comes out not correct.

These drive the whole of a run but the look for a card: the cell's
set-up, warm-up, window and comparison, on the CPU at a small store,
with one fault planted in the program under the recorder: an answer
altered where it is produced, half of the batch left out, a
cross-encoder logit altered. A sound run of the same size comes out
correct."""

import pytest

from benchmark import harness

SMALL_SEARCH = dict(workload="legal-2620.search64", overrides={"n_chunks": 300},
                    mix_overrides={"distinct_batches": 3, "batch": 16,
                                   "judged": 3})
SMALL_QUERY = dict(workload="legal-2620.query-open",
                   overrides={"n_chunks": 150},
                   mix_overrides={"rate_qps": 2.0, "judged": 8,
                                  "warm_s": 1.0})


def run(small, seed, mutate=None, seconds=1.0):
    return harness.run_cell(small["workload"], seed, seconds, False,
                            device="cpu", overrides=small["overrides"],
                            mix_overrides=small["mix_overrides"],
                            mutate=mutate)


def break_search(how):
    def mutate(eng, ret):
        co = ret._coalescer
        sound = co._fn

        def broken(queries, k, hybrid_weights, mode):
            if how == "half":
                # the second half of the batch answered as the first
                half = (len(queries) + 1) // 2
                rows = sound(queries[:half], k=k,
                             hybrid_weights=hybrid_weights[:half], mode=mode)
                return (rows + rows)[:len(queries)]
            rows = sound(queries, k=k, hybrid_weights=hybrid_weights, mode=mode)
            r = rows[0][0]
            r.doc_id = (r.doc_id + 1) % ret.store.n_docs
            r.chunk = ret.store.chunks[r.doc_id]
            return rows
        co._fn = broken
    return mutate


def test_sound_search_run_is_correct():
    res = run(SMALL_SEARCH, 21)
    assert res["correct"], res["checks"]
    assert res["metrics"]["search_qps"]["value"] > 0


@pytest.mark.parametrize("how", ["altered", "half"])
def test_broken_search_is_not_correct(how):
    res = run(SMALL_SEARCH, 22, break_search(how))
    assert not res["correct"]
    assert res["checks"]["rank_band"]["value"] > \
        res["checks"]["rank_band"]["limit"]


def test_query_faults():
    def altered_logit(eng, ret):
        ce = eng.orchestrator.reranker
        sound = ce.score_pairs

        def broken(queries, docs):
            out = sound(queries, docs).copy()
            out[0] += 10.0
            return out
        ce.score_pairs = broken
    res = run(SMALL_QUERY, 23, altered_logit, seconds=3.0)
    assert not res["correct"]
    assert res["checks"]["ce_gap"]["value"] > res["checks"]["ce_gap"]["limit"]
    res = run(SMALL_QUERY, 24, break_search("altered"), seconds=3.0)
    assert not res["correct"]
    assert res["checks"]["rank_band"]["value"] > \
        res["checks"]["rank_band"]["limit"]
