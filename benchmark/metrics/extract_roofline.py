"""``extract_roofline``: the speechpy suite's share of its roofline, in %:
the least time the card needs for the work of ``api.extract``'s four heads
(``mfe`` with its frame energies, ``lmfe``, ``ssc``, ``mfcc``) over the
device time a call of every device operation of the traced slice (the
products, the heads' elementwise work, the fill, the bucket tail's zeros,
the copy-out).  The path has no single kernel, so its glue reads as lost
share.

The work is frozen here: the algorithm's count for the caller's true input
(rows x samples) and the configuration, whatever implements it, never a
lowering's own plan, the bucketed or the padded length.  For each output
frame (speechpy framing, no zero padding: floor((T - fl) / step) frames a
row), with N the FFT size, m mels, c cepstra:

* the real FFT of N points, 2.5 N log2 N;
* the power, 3 a bin over N/2 + 1 bins;
* three mel projections at 2 a nonzero filterbank weight: the mel energies
  and the SSC's numerator and denominator;
* the SSC's frequency weighting, N/2 + 1 multiplies, and its m divisions;
* the log of the m mel energies, m;
* the DCT, 2 m c;
* the frame energy: N/2 + 1 adds and one log.

Bytes: the float32 input read once and the float32 outputs written once,
2 m + 1 + m + c floats a frame (``mfe`` and its energy, ``lmfe``, ``ssc``,
``mfcc``).  The least time is the larger of operations over the FP32 peak
and bytes over the HBM peak: bytes bound it at 64 x 160,000.
"""

import math

from benchkit.card import least_seconds
from reference import plain


def frames(samples: int, kw: dict) -> int:
    sr = kw["sample_rate"]
    fl = int(round(sr * kw.get("frame_length", 0.020)))
    step = int(round(sr * kw.get("frame_stride", 0.01)))
    return max((samples - fl) // step, 0)


def work(rows: int, samples: int, kw: dict) -> tuple:
    """(operations, bytes) of one call on (rows, samples)."""
    n = kw.get("fft_length", 512)
    m, c = kw.get("num_filters", 40), kw.get("num_cepstral", 13)
    nnz = plain.filterbank_nonzeros("speechpy_mfcc", kw)
    bins = n // 2 + 1
    per_frame = (2.5 * n * math.log2(n) + 3 * bins + 3 * 2 * nnz + bins + m + m + 2 * m * c
                 + bins + 1)
    f = rows * frames(samples, kw)
    return per_frame * f, 4 * rows * samples + 4 * f * (3 * m + 1 + c)


def read(ctx):
    t = ctx.trace
    if t is None or not t.calls or not t.device:
        return None
    least, _ = least_seconds(*work(*ctx.work_shape, ctx.config["reference"]["kwargs"]))
    return 100.0 * least / (t.device_s() / t.calls)
