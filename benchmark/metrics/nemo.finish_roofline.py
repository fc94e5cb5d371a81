"""``nemo.finish_roofline``: the NeMo finish's share of its roofline, in %:
the least time the card needs for the finish's work over the device time a
call of its kernel events (``nemo_finish``: the statistics in parts, then
the normalising transpose, ``ops/cuda/nemo_logmel.cu``; profiler trace).

The work is frozen here, whatever implements it: K2's float32 (rows,
frames, mels) power read once for the frames each row's answer needs (min(1
+ len // hop, frames) a row: the rest become zeros and need no read), and
the float32 (rows, mels, frames) answer written once, frames = 1 + T // hop
of the padded batch; 8 operations a value read (the guard, the log, the
mean's and the deviation's updates, the difference and the division).
Bytes bind it.  The least time of each batch is averaged over the batches,
which the traced slice's calls cycle through evenly; their shapes and
lengths come from the driver's window record (``drivers/device_nemo.py``:
``batches``)."""

import statistics

from benchkit import card

EVENTS = ("nemo_finish",)
OPS_PER_VALUE = 8


def work(samples: int, lengths, fc: dict) -> tuple:
    """(operations, bytes) of one call on rows of ``lengths`` samples padded
    to ``samples``, under the configuration's ``feature_config``."""
    hop, m = fc["frame_stride_samples"], fc["num_filters"]
    frames = 1 + samples // hop
    needed = sum(min(n // hop + 1, frames) if n > 0 else 0 for n in map(int, lengths))
    return OPS_PER_VALUE * needed * m, 4 * needed * m + 4 * len(lengths) * m * frames


def read(ctx):
    t, batches = ctx.trace, ctx.window.get("batches")
    if t is None or not t.calls or not batches or not t.count(*EVENTS):
        return None
    fc = ctx.config["feature_config"]
    least = statistics.mean(card.least_seconds(*work(s, lens, fc))[0] for s, lens in batches)
    return 100.0 * least / (t.device_s(*EVENTS) / t.calls)
