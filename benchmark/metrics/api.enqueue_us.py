"""``api.enqueue_us``: host µs to enqueue one call of the entry point, for
groups of calls queued behind a device spin so that no call waits for the
device (host clock; the driver's ``enqueue_us``)."""


def read(ctx):
    return ctx.enqueue_us
