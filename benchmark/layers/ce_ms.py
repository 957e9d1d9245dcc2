"""The cross-encoder rerank's mean ms a call over the window
(``StageTimer`` ``ce``: ``CrossEncoder.score_pairs``, the pairs'
WordPiece and the program's fill, replay and copy-out)."""


def read(ctx):
    return ctx.stage_ms("ce")
