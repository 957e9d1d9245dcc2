"""The query classifier's mean ms a request over the window
(``StageTimer`` ``classify``: ``QueryClassifier.classify`` as the
orchestrator calls it)."""


def read(ctx):
    return ctx.stage_ms("classify")
