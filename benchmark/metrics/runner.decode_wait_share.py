"""``runner.decode_wait_share``: the corpus runner's ``Meter`` scope ``decode_wait`` (host
clock, main thread) summed over the window's passes, over the window."""


def read(ctx):
    v = ctx.scopes.get("decode_wait")
    return v / ctx.window["wall_s"] if v is not None and ctx.window.get("wall_s") else None
