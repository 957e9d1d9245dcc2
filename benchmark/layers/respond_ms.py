"""The responder's mean ms a request over the window (``StageTimer``
``respond``: ``generate_response`` and the adapted view with its
sentence attribution)."""


def read(ctx):
    return ctx.stage_ms("respond")
