"""``graphs.fill_us``: host µs a call in the ``graphs.fill`` span
(``mfcc_rust_tpu_torch/utils/graphs.py``): the enqueue of the caller's fill
of the static input (the copy, the bucket tail's zeros, the centre pad's
edges).  The median over the calls of :mod:`benchkit.spans`'s burst."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "graphs.fill")
