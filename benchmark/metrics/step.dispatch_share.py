"""``step.dispatch_share``: the corpus runner's ``Meter`` scope ``dispatch``
(the parallel step's call: fill, graph replay, copy-out enqueued; host
clock) summed over the window's passes, over the window."""


def read(ctx):
    v = ctx.scopes.get("dispatch")
    return v / ctx.window["wall_s"] if v is not None and ctx.window.get("wall_s") else None
