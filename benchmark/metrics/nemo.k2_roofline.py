"""``nemo.k2_roofline``: K2's (``ops/cuda/ct_mel.cu``) share of its
roofline in the NeMo cell, in %: the least time the card needs for the K2
work that a call's answer needs over the device time a call of K2's kernel
events (profiler trace).

The work is ``k2_roofline``'s frozen count (loaded from its file, not
copied) of each row at its true length at the configuration's n_fft, hop,
mels and sample rate: the row's 1 + len // hop frames (NeMo's frame count)
and its samples, summed over the rows of a batch; the least time of each
batch averaged over the batches, which the traced slice's calls cycle
through evenly.  The batches' shapes and lengths come from the driver's
window record (``drivers/device_nemo.py``: ``batches``).  K2's ragged
kernel runs the 16-frame tiles that hold a row's own frames; what it runs
past them in a row's last tile is not counted."""

import statistics

from benchkit import card, spec

_k2 = spec.metric("k2_roofline")


def kwargs(ctx) -> dict:
    """The configuration's K2 settings as ``k2_roofline.work`` reads them."""
    fc = ctx.config["feature_config"]
    return {"sr": fc["sample_rate"], "n_fft": fc["fft_points"],
            "hop_length": fc["frame_stride_samples"], "n_mels": fc["num_filters"]}


def batch_work(lengths, kw: dict) -> tuple:
    """(operations, bytes) of the frames that rows of ``lengths`` samples
    need."""
    ops, nbytes = 0.0, 0.0
    for n in lengths:
        o, b = _k2.work(1, int(n), kw)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def read(ctx):
    t, batches = ctx.trace, ctx.window.get("batches")
    if t is None or not t.calls or not batches or not t.count(*_k2.EVENTS):
        return None
    kw = kwargs(ctx)
    least = statistics.mean(card.least_seconds(*batch_work(lens, kw))[0] for _, lens in batches)
    return 100.0 * least / (t.device_s(*_k2.EVENTS) / t.calls)
