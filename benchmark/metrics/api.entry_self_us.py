"""``api.entry_self_us``: host µs a call in the entry point's own span
(``api.<function>``, ``mfcc_rust_tpu_torch/api.py``) outside the
``graphs.run`` it calls: the config lookup, ``as_tensor``, the device, the
eager rule, the bucket, the centre pad's edge index, the fill's closure,
the pad counter and the final trim.  The median self time over the calls
of :mod:`benchkit.spans`'s burst (the program's spans, on the host clock)."""

from benchkit import spans


def read(ctx):
    return spans.median_us(ctx, "api." + ctx.config["api"]["function"])
