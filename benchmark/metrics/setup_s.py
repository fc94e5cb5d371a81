"""``setup_s``: seconds from the start of the process to the first timed
call: imports, kernel builds on a checkout's first run, inputs, captures
and warm-up (host clock)."""


def read(ctx):
    return ctx.window.get("setup_s")
