"""``graphs.replay_us``: host µs a call in the ``graphs.replay`` span
(``mfcc_rust_tpu_torch/utils/graphs.py``): the graph's launch, and any wait
for room in the launch queue.  The median over the calls of
:mod:`benchkit.spans`'s burst."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "graphs.replay")
