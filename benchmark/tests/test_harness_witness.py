"""The witness serves a mix's batches through two of the program's BM25
paths and judges both against the reference (on the CPU, at a small
store)."""

from benchmark import harness, witness


def test_witness_judges_both_paths():
    config = harness.load_json(harness.HERE / "configs" / "legal-1m.json")
    config.update(n_docs=3000, vocab_size=4000)
    mix = harness.load_json(harness.HERE / "traffic" / "search64-rare.json")
    mix.update(batch=16, queries=dict(mix["queries"], rank_lo=100,
                                      rank_hi=4000))
    out = witness.witness(config, mix, 31, 3, whole=2,
                          paths=("segsum", "scatter"), device="cpu")
    assert out["queries"] == 48 and out["whole_batches"] == 2
    for path in ("segsum", "scatter"):
        assert sum(n for _, n in out["bands"][path]) >= 32
    assert all(b <= witness.ROUNDING for b, _ in out["bands"]["scatter"])
