"""Device dispatches of the search (``RetrievalEngine.device_dispatches``)
over the window, a request completed: under coalescing, below the
searches a request makes."""


def read(ctx):
    if not ctx.requests_done:
        return None
    return ctx.counter_delta("device_dispatches") / ctx.requests_done
