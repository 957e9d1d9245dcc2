"""Kernel K1's share of its roofline over the traced stretch: the least
time its searches could take (``k1_bytes.py``: the doc matrix read once
a traced batch, plus the real queries' embeddings, over 3.35 TB/s) over
the device time of the trace's kernels whose names contain
``segmax_rm``. Nothing where the stretch launched no such kernel (a
store below the two-phase threshold)."""

from benchmark.layers.k1_bytes import k1_least_seconds

K1_NAME = "segmax_rm"


def read(ctx):
    if ctx.trace is None or not ctx.traced_batches:
        return None
    kernel_s = 1e-6 * sum(e["dur"] for e in ctx.trace.device_ops
                          if e.get("cat") == "kernel"
                          and K1_NAME in e.get("name", ""))
    if kernel_s <= 0:
        return None
    least = sum(k1_least_seconds(b.q_real, ctx.n_docs, ctx.dim, ctx.doc_bytes)
                for b in ctx.traced_batches)
    return 100.0 * least / kernel_s
