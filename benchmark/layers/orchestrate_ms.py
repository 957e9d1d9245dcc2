"""The orchestration's self time, mean ms a request over the window:
``request`` (the whole of ``LegalEngine.query``) less the spans it holds
on the request's thread, over the requests. What is left is the merge,
the form policy, the dense-union interleave, the CE blend, the rule
boosts, the parent expansion and the dicts."""

INSIDE = ("classify", "search", "ce", "respond")


def read(ctx):
    request = ctx.stages.get("request")
    if not request or request["count"] <= 0:
        return None
    inside = sum(ctx.stages[name]["total_s"] for name in INSIDE
                 if name in ctx.stages)
    return 1e3 * (request["total_s"] - inside) / request["count"]
