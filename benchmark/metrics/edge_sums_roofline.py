"""``edge_sums_roofline``: the edge kernel's (``ops/cuda/speechpy_edges.cu``,
X_0 and X_{N/2} of each speechpy frame summed in float64 on the chunk-GEMM
path) share of its roofline, in %: the least time the card needs for the
call's work over the device time a call of the kernel's events (profiler
trace).

The work is frozen here: the algorithm's count for the caller's true input
(rows x samples) and the configuration, never the kernel's own plan or the
bucketed length.  For each output frame (speechpy framing, no zero padding:
floor((T - fl) / step) frames a row): fl window products and 2 fl adds, the
plain and the alternating sums.  Bytes: the float32 input read once and
three float32 values a frame written (X_0 twice, X_{N/2} once).  The least
time is the larger of operations over the FP32 peak and bytes over the HBM
peak: bytes bound it.
"""

from benchkit import spec
from benchkit.card import roofline_share

EVENTS = ("edge_sums_kernel",)
frames = spec.metric("extract_roofline").frames


def work(rows: int, samples: int, kw: dict) -> tuple:
    """(operations, bytes) of one call on (rows, samples)."""
    fl = int(round(kw["sample_rate"] * kw.get("frame_length", 0.020)))
    f = rows * frames(samples, kw)
    return 3 * fl * f, 4 * rows * samples + 4 * 3 * f


def read(ctx):
    return roofline_share(ctx, EVENTS, work)
