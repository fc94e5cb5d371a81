"""``device.idle_share``: the share of the measured window in which the
device ran nothing.  The traced slice gives the device's busy time a unit
of work (the union of its kernels, copies and fills a call, or a pass,
from the profiler trace); the window gives its units and wall seconds, so
the profiler's own host cost does not count as idle:
1 - busy a unit x units in the window / the window's seconds."""


def read(ctx):
    t, w = ctx.trace, ctx.window
    if t is None or not t.device or not t.calls or not w.get("wall_s"):
        return None
    return 1.0 - t.busy_s / t.calls * w["units"] / w["wall_s"]
