"""``whisper.k2_roofline``: K2's (``ops/cuda/ct_mel.cu``) share of its
roofline in the Whisper cell, in %: the least time the card needs for the
call's K2 work over the device time a call of K2's kernel events (profiler
trace).  The work is ``k2_roofline``'s frozen count (loaded from its file,
not copied) for the caller's rows x samples at the configuration's n_fft,
hop, mels and sample rate: every one of the 1 + T // hop centred frames K2
computes, the one Whisper drops included."""

from benchkit import card, spec

_k2 = spec.metric("k2_roofline")


def kwargs(ctx) -> dict:
    """The configuration's K2 settings as ``k2_roofline.work`` reads them."""
    fc = ctx.config["feature_config"]
    return {"sr": fc["sample_rate"], "n_fft": fc["fft_points"],
            "hop_length": fc["frame_stride_samples"], "n_mels": fc["num_filters"]}


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.count(*_k2.EVENTS):
        return None
    least, _ = card.least_seconds(*_k2.work(*ctx.work_shape, kwargs(ctx)))
    return 100.0 * least / (t.device_s(*_k2.EVENTS) / t.calls)
