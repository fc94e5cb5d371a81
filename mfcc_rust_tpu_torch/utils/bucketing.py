"""Length bucketing for ragged utterances.

Lengths are quantized to a small geometric set of buckets, so that a
service sees few distinct input shapes while padding waste stays bounded
(~25%).  The same grid as the JAX package, so both bucket a length alike.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_MIN_BUCKET = 2048
DEFAULT_GROWTH = 1.25


def bucket_length(
    n: int, min_bucket: int = DEFAULT_MIN_BUCKET, growth: float = DEFAULT_GROWTH
) -> int:
    """Smallest bucket >= n from the geometric grid
    ``min_bucket * growth**k``, rounded up to a multiple of 128 samples."""
    if n <= min_bucket:
        return min_bucket
    k = math.ceil(math.log(n / min_bucket) / math.log(growth))
    b = int(math.ceil(min_bucket * growth**k))
    return ((b + 127) // 128) * 128


def pad_to_bucket(signal: np.ndarray, min_bucket: int = DEFAULT_MIN_BUCKET,
                  growth: float = DEFAULT_GROWTH) -> Tuple[np.ndarray, int]:
    """Zero-pad the last axis to its bucket; returns (padded, true_length)."""
    n = signal.shape[-1]
    b = bucket_length(n, min_bucket, growth)
    if b == n:
        return signal, n
    pad = [(0, 0)] * (signal.ndim - 1) + [(0, b - n)]
    return np.pad(signal, pad), n


def bucket_batch(
    lengths: Sequence[int], batch_size: int,
    min_bucket: int = DEFAULT_MIN_BUCKET, growth: float = DEFAULT_GROWTH,
) -> List[List[int]]:
    """Group utterance indices into batches of equal bucket size: sort by
    bucketed length, emit contiguous groups of ``batch_size`` sharing one
    bucket.  Returns a list of index lists."""
    order = np.argsort(np.asarray(lengths))
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_bucket = -1
    for idx in order:
        b = bucket_length(int(lengths[idx]), min_bucket, growth)
        if len(cur) == batch_size or (cur and b != cur_bucket):
            batches.append(cur)
            cur = []
        cur.append(int(idx))
        cur_bucket = b
    if cur:
        batches.append(cur)
    return batches
