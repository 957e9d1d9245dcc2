"""The host postings gather's mean ms a call over the window
(``StageTimer`` ``postings``)."""


def read(ctx):
    return ctx.stage_ms("postings")
