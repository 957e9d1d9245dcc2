"""The postings cut, mean ms a dispatch that cut a query over the window
(``StageTimer`` ``postings_cut``: inside ``postings``, the time the
native gather measured on the rows it cut by weight, recorded with
``StageTimer.add``). Nothing from a program without the span, or from a
window in which no query passed the postings budget."""


def read(ctx):
    return ctx.stage_ms("postings_cut")
