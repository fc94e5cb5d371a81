"""``graphs.run_self_us``: host µs a call in ``GraphCache.run``'s own span
(``graphs.run``, ``mfcc_rust_tpu_torch/utils/graphs.py``) outside its fill,
replay and copy-out: the key (the current device, inference mode), the
lock, the LRU, the state check, the outputs' allocation, the two stream
waits and the launch counts.  The median self time over the calls of
:mod:`benchkit.spans`'s burst."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "graphs.run")
