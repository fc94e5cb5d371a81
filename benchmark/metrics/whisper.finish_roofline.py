"""``whisper.finish_roofline``: the Whisper finish's share of its roofline,
in %: the least time the card needs for the finish's work over the device
time a call of the finish's kernel events (``whisper_logmel``: the rows'
maxima and the finish, ``ops/cuda/whisper_logmel.cu``; profiler trace).

The work is frozen here, whatever implements it: K2's float32 (rows,
frames, mels) mel power read once, frames = 1 + T // hop (the dropped frame
is read too), and the float32 (rows, mels, T // hop) answer written once;
6 operations a kept value (the clamp, the log, the row's maximum, the
floor's maximum, the add and the scale).  Bytes bind it."""

from benchkit import card

EVENTS = ("whisper_logmel",)
OPS_PER_VALUE = 6


def work(rows: int, samples: int, fc: dict) -> tuple:
    """(operations, bytes) of one call on (rows, samples) under the
    configuration's ``feature_config``."""
    kept = samples // fc["frame_stride_samples"]
    m = fc["num_filters"]
    return (OPS_PER_VALUE * rows * m * kept,
            4 * rows * (kept + 1) * m + 4 * rows * m * kept)


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.count(*EVENTS):
        return None
    least, _ = card.least_seconds(*work(*ctx.work_shape, ctx.config["feature_config"]))
    return 100.0 * least / (t.device_s(*EVENTS) / t.calls)
