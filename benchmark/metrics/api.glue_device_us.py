"""``api.glue_device_us``: device µs a call spent outside the cell's kernel:
the static input's fill, the bucket tail's zeros, the centre pad's edges,
the copy-out.  The traced slice's device time (kernels, copies, fills) a
call, less the kernel's (``kernel_events`` of the configuration)."""


def read(ctx):
    t = ctx.trace
    names = ctx.config.get("kernel_events", [])
    if t is None or not t.calls or not names or not t.count(*names):
        return None
    return 1e6 * (t.device_s() - t.device_s(*names)) / t.calls
