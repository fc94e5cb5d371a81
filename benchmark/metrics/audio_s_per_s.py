"""``audio_s_per_s``: seconds of input audio whose features were completed
in the window, over the window's wall seconds (host clock; the window ends
at a device synchronise, or at the last file written)."""


def read(ctx):
    w = ctx.window
    return w["audio_s"] / w["wall_s"] if w.get("wall_s") else None
