"""``extract.elementwise_us``: device µs a call of the replayed graph's
operations outside the product kernels (``metrics/extract.products_us.py``'s
``EVENTS``): the heads' elementwise work and reductions, and the edge sums.
The graph's operations are those its launch enqueues
(:mod:`benchkit.replay_split`); the fill, the bucket tail's zeros and the
copy-out are ``graphs.glue_device_us``.  With ``extract.products_us`` and
``graphs.glue_device_us`` it adds up to the device time a call."""

from benchkit import replay_split, spec

EVENTS = spec.metric("extract.products_us").EVENTS


def read(ctx):
    s = replay_split.numbers(ctx)
    if s is None:
        return None
    return sum(us for name, us in s["replay_ops"].items() if not any(e in name for e in EVENTS))
