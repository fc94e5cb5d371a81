"""``nemo.prologue_roofline``: the NeMo prologue's share of its roofline, in
%: the least time the card needs for the prologue's work over the device
time a call of its kernel events (``nemo_prologue``: preemphasis within
each row's length, zeros past it and the centre pad,
``ops/cuda/nemo_logmel.cu``; profiler trace).

The work is frozen here, whatever implements it: each row's true samples,
float32, read once (the samples past a row's length are zeros and need no
read), and of each row of the float32 (rows, T + n_fft) padded batch the
min(len, T) + n_fft samples that the row's own frames read written once
(K2 reads no further: its ragged kernel skips the tiles past them); 2
operations a sample read (the product and the difference).  Bytes bind
it.  The least time of each batch is averaged over the batches, which the
traced slice's calls cycle through evenly; their shapes and lengths come
from the driver's window record (``drivers/device_nemo.py``:
``batches``)."""

import statistics

from benchkit import card

EVENTS = ("nemo_prologue",)
OPS_PER_SAMPLE = 2


def work(samples: int, lengths, fc: dict) -> tuple:
    """(operations, bytes) of one call on rows of ``lengths`` samples padded
    to ``samples``, under the configuration's ``feature_config``."""
    true = sum(min(max(int(n), 0), samples) for n in lengths)
    return (OPS_PER_SAMPLE * true,
            4 * true + 4 * (true + len(lengths) * fc["fft_points"]))


def read(ctx):
    t, batches = ctx.trace, ctx.window.get("batches")
    if t is None or not t.calls or not batches or not t.count(*EVENTS):
        return None
    fc = ctx.config["feature_config"]
    least = statistics.mean(card.least_seconds(*work(s, lens, fc))[0] for s, lens in batches)
    return 100.0 * least / (t.device_s(*EVENTS) / t.calls)
