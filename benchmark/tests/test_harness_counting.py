"""The operation and byte counts, by hand on small shapes."""

from benchmark.layers import counting


def test_search_counts():
    # 2 queries over 10 docs of width 4, fp32 docs, 7 postings, k 3
    assert counting.search_bytes(2, 10, 4, 4, 7, 3) == 160 + 32 + 56 + 48
    assert counting.search_ops(2, 10, 4, 7) == 2 * 2 * 10 * 4 + 7


def test_least_seconds_takes_the_larger_bound():
    assert counting.least_seconds(3.35e12, 0) == 1.0
    assert counting.least_seconds(0, 989e12) == 1.0
    assert counting.least_seconds(3.35e12, 2 * 989e12) == 2.0


def test_minilm_ops():
    # one layer, hidden 2, intermediate 3, one sequence of 5 tokens:
    # 4 projections of 2*5*2*2 = 40 each, scores and weighted sum
    # 2*5*5*2 = 100 each, feed-forward in and out 2*5*2*3 = 60 each
    assert counting.minilm_ops([5], 2, 1, 3) == 4 * 40 + 2 * 100 + 2 * 60
    assert counting.minilm_ops([5, 5], 2, 2, 3) == 4 * 480
