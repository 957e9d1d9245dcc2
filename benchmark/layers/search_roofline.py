"""The search program's share of its roofline over the traced stretch:
the least time the card could take for the stretch's searches
(``counting.py``) over the device time of the kernels that the
``device_search`` span launched."""

from benchmark.layers import counting


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    kernel_s = ctx.trace.kernel_span.get("device_search", 0.0)
    if kernel_s <= 0:
        return None
    least = sum(counting.least_seconds(
        counting.search_bytes(b.q_real, ctx.n_docs, ctx.dim, ctx.doc_bytes,
                              b.postings, b.k),
        counting.search_ops(b.q_real, ctx.n_docs, ctx.dim, b.postings))
        for b in ctx.traced_batches)
    return 100.0 * least / kernel_s
