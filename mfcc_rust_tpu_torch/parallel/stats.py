"""Distributed corpus statistics — the all-reduce generalization of ``cmvn``.

The reference's CMVN is a two-pass in-memory reduction over one feature
matrix.  At corpus scale the moments are accumulated per shard and reduced
across the mesh.

Numerics: the naive (sum, sum_sq) accumulation computes the variance as
``E[x^2] - mean^2``, which cancels catastrophically in float32 for
large-mean features (mean 1e4 -> mean^2 1e8, where f32 resolution is ~8 —
the entire variance of unit-scale data vanishes).  Moments are therefore
carried in Welford/Chan form ``(count, mean, M2 = sum((x - mean)^2))``:
every quantity stays at data scale, merging two states is the numerically
stable Chan update, and the distributed reduction composes from all-reduces
of count / count-weighted mean / shifted M2.  A deterministic pairwise merge
is provided for bit-reproducible multi-round accumulation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.normalize import EPS


class CorpusMoments(NamedTuple):
    """Running Welford/Chan state over feature dimension D:
    ``count`` (scalar), ``mean`` (D,), ``m2 = sum((x - mean)^2)`` (D,).

    Array-namespace agnostic by design: ``merge``/``total``/``variance``/
    ``std``/``normalize`` use only operators, so numpy states stay numpy
    (the runner's host-side accumulation never touches the device) and
    tensor states stay tensors."""

    count: object  # scalar
    mean: object  # (D,)
    m2: object  # (D,)

    @classmethod
    def zeros(cls, dim: int, dtype=None) -> "CorpusMoments":
        dtype = np.float32 if dtype is None else dtype
        return cls(np.zeros((), dtype), np.zeros(dim, dtype), np.zeros(dim, dtype))

    def merge(self, other: "CorpusMoments") -> "CorpusMoments":
        """Chan's parallel combine: stable for any mean magnitude, exact for
        empty operands."""
        n = self.count + other.count
        w = other.count / (n + (n == 0))  # == other.count / max(n, 1)
        delta = other.mean - self.mean
        mean = self.mean + delta * w
        m2 = self.m2 + other.m2 + (delta * delta) * (self.count * w)
        return CorpusMoments(n, mean, m2)

    @property
    def total(self):
        """Derived plain sum (kept for reporting/tests)."""
        return self.mean * self.count

    @property
    def variance(self):
        n = self.count
        v = self.m2 / (n + (n == 0))
        return v * (v > 0)  # clip stray negative rounding residue

    @property
    def std(self):
        return self.variance ** 0.5

    def normalize(self, feats, variance_normalization=True):
        out = feats - self.mean
        if variance_normalization:
            out = out / (self.std + EPS)
        return out


def local_moments(feats: torch.Tensor, mask: Optional[torch.Tensor] = None) -> CorpusMoments:
    """Masked local moments of (..., T, D) features (mask: (..., T)) in the
    stable two-pass form: mean first, then the centered sum of squares."""
    red = tuple(range(feats.ndim - 1))
    if mask is None:
        n = torch.tensor(float(np.prod(feats.shape[:-1])), dtype=feats.dtype,
                         device=feats.device)
        nz = torch.clamp(n, min=1.0)
        if not red:  # a (D,) vector: one row
            m1 = feats / nz
            mean = m1 + (feats - m1) / nz
            d = feats - mean
            return CorpusMoments(n, mean, d * d)
        m1 = torch.sum(feats, dim=red) / nz
        mean = m1 + torch.sum(feats - m1, dim=red) / nz  # two-pass refinement
        d = feats - mean
        return CorpusMoments(n, mean, torch.sum(d * d, dim=red))
    m = mask[..., None].to(feats.dtype)
    n = torch.sum(m)
    nz = torch.clamp(n, min=1.0)
    m1 = torch.sum(feats * m, dim=red) / nz
    mean = m1 + torch.sum((feats - m1) * m, dim=red) / nz
    d = (feats - mean) * m
    return CorpusMoments(n, mean, torch.sum(d * d, dim=red))


def psum_moments(m: CorpusMoments, mesh) -> CorpusMoments:
    """All-reduce Welford states over every rank of ``mesh`` (the mesh's
    world group; on the one-rank mesh the sums are identities and the
    arithmetic is the same).  The distributed Chan combine: global count and
    count-weighted mean by all-reduce, then each rank re-centers its M2 on
    the global mean before the final all-reduce (no sum-of-squares ever
    forms).  Every rank of the mesh must call it."""
    n = mesh.all_reduce(m.count.clone())
    mean = mesh.all_reduce(m.mean * m.count) / torch.clamp(n, min=1.0)
    delta = m.mean - mean
    m2 = mesh.all_reduce(m.m2 + (delta * delta) * m.count)
    return CorpusMoments(n, mean, m2)


def tree_merge(moments: Sequence[CorpusMoments]) -> CorpusMoments:
    """Deterministic pairwise (tree) reduction of host-side moment
    checkpoints — fixed association order for bit-reproducible corpus CMVN
    regardless of shard arrival order."""
    items = list(moments)
    if not items:
        raise ValueError("no moments to merge")
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(items[i].merge(items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
