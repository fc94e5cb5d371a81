"""``api.direct_us``: host µs a call in the ``api.direct`` span
(``mfcc_rust_tpu_torch/api.py``): the enqueue of a call that is one launch
of K1 on the caller's signal (the move to the device and float32 where
needed, the counters, the result's allocation and the launch).  The median
self time over the calls of :mod:`benchkit.spans`'s burst; None where the
program has no such span (a commit before it) or no call took the path."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "api.direct")
