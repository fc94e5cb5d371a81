"""``k2_roofline``: K2's (``ops/cuda/ct_mel.cu``) share of its roofline, in
%: the least time the card needs for the call's work over the device time
a call of K2's kernel events (profiler trace).

The work is frozen here: the algorithm's count for the caller's true input
(rows x samples) and the configuration, whatever implements it, never a
kernel's own plan, the bucketed or the padded length.  For each output
frame (librosa's centred framing: 1 + T // hop frames a row):

* the window, N multiplies;
* the real FFT of N points, 2.5 N log2 N;
* the power, 3 a bin over N/2 + 1 bins;
* the mel projection, 2 a nonzero filterbank weight.

Bytes: the float32 input read once and the float32 (rows, m, frames)
output written once.  The least time is the larger of operations over the
FP32 peak and bytes over the HBM peak: operations bound it at 2048/512/128
on 32 x 220,500, bytes at 512/160/80 on 64 x 160,000.
"""

import math

from benchkit.card import roofline_share
from reference import plain

EVENTS = ("ct_mel",)  # K2's kernels: ct_mel_fft_kernel (path 1), ct_mel_kernel (path 2)


def frames(samples: int, kw: dict) -> int:
    return 1 + samples // kw.get("hop_length", 512)


def work(rows: int, samples: int, kw: dict) -> tuple:
    """(operations, bytes) of one call on (rows, samples)."""
    n = kw.get("n_fft", 2048)
    m = kw.get("n_mels", 128)
    nnz = plain.filterbank_nonzeros("librosa_mel", kw)
    per_frame = n + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * nnz
    f = rows * frames(samples, kw)
    return per_frame * f, 4 * rows * samples + 4 * f * m


def read(ctx):
    return roofline_share(ctx, EVENTS, work)
