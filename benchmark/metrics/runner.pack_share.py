"""``runner.pack_share``: the corpus runner's ``Meter`` scope ``pack`` (host
clock, main thread) summed over the window's passes, over the window."""


def read(ctx):
    v = ctx.scopes.get("pack")
    return v / ctx.window["wall_s"] if v is not None and ctx.window.get("wall_s") else None
