"""The cross-encoder's pair encoding, mean ms a call over the window
(``StageTimer`` ``ce_tokenize``: the WordPiece of a rerank's pairs and
their padded ids, mask and segment ids, inside ``ce``). None on a
program without the span."""


def read(ctx):
    return ctx.stage_ms("ce_tokenize")
