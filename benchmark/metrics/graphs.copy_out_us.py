"""``graphs.copy_out_us``: host µs a call in the ``graphs.copy_out`` span
(``mfcc_rust_tpu_torch/utils/graphs.py``): the enqueue of the copy of the
static outputs into the call's fresh tensors.  The median over the calls
of :mod:`benchkit.spans`'s burst."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "graphs.copy_out")
