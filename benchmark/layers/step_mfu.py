"""The whole step's share of the card's peak over the window: the query
encoder's MiniLM operations over the real tokens and the dense scoring's
``2 Q N D``, over the window's wall time at 989 TFLOP/s."""

from benchmark.layers import counting


def read(ctx):
    if not ctx.window_batches or ctx.window_s <= 0:
        return None
    enc = ctx.config["encoder"]
    ops = 0
    for b in ctx.window_batches:
        ops += counting.minilm_ops(b.token_lengths, enc["hidden"],
                                   enc["layers"], enc["intermediate"])
        ops += 2 * b.q_real * ctx.n_docs * ctx.dim
    return 100.0 * ops / (ctx.window_s * counting.PEAK_FLOPS)
