"""``k1_roofline``: K1's (``ops/cuda/speechpy_mfcc.cu``) share of its
roofline, in %: the least time the card needs for the call's work over the
device time a call of K1's kernel events (profiler trace).

The work is frozen here: the algorithm's count for the caller's true input
(rows x samples) and the configuration, whatever implements it, never a
kernel's own plan, the bucketed or the padded length.  Bucket waste and pad
traffic read as lost share.  For each output frame (speechpy framing, no
zero padding: floor((T - fl) / step) frames a row):

* the real FFT of N points, 2.5 N log2 N;
* the power, 3 a bin over N/2 + 1 bins;
* the mel projection, 2 a nonzero filterbank weight;
* the log of the m mel energies, m;
* the DCT, 2 m c;
* the frame energy that dc-elimination puts in place of c0: N/2 + 1 adds
  and one log.

Bytes: the float32 input read once and the float32 (rows, frames, c)
output written once.  The least time is the larger of operations over the
FP32 peak and bytes over the HBM peak; at 48 x 160,000 operations bound it.
"""

import math

from benchkit.card import roofline_share
from reference import plain

EVENTS = ("mfcc_fft_kernel",)  # K1's kernel, path 1 and path 2 alike


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
    per_frame = 2.5 * n * math.log2(n) + 3 * bins + 2 * nnz + m + 2 * m * c
    if kw.get("dc_elimination", True):
        per_frame += bins + 1
    f = rows * frames(samples, kw)
    return per_frame * f, 4 * rows * samples + 4 * f * c


def read(ctx):
    return roofline_share(ctx, EVENTS, work)
