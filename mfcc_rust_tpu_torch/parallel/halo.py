"""Halo-exchange blockwise framing: sequence (time-axis) parallelism.

The reference handles long audio with a serial O(window) carry buffer.  The
distributed generalization shards the time axis over the mesh's ``seq``
axis and exchanges only the ``frame_len - hop`` boundary samples between
neighbouring ranks of one data row, point to point
(``dist.batch_isend_irecv``: blocking send/recv pairs deadlock on gloo).

Two variants, differing only in which side the halo comes from:

* :func:`sharded_frames_left_halo` — the streaming/vorbis layout: frame ``c``
  ends at sample ``(c+1)*hop``, so each shard needs the *previous* shard's
  tail (the distributed analysis memory).
* :func:`sharded_frames_right_halo` — the framed/speechpy layout: frame ``j``
  starts at ``j*hop``, so each shard needs the *next* shard's head.

Every rank of the data row calls them together with its own time shard;
the local chunk length must be a multiple of the hop.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import FeatureConfig
from ..ops import framing
from ..ops.spectrum import rdft


def _exchange(send: torch.Tensor, to_prev: bool, mesh) -> torch.Tensor:
    """Send ``send`` to the previous (``to_prev``) or next rank of this data
    row and return what the other neighbour sent (zeros at the row's edge
    that has no such neighbour)."""
    n = mesh.shape["seq"]
    s = mesh.coords[1]
    recv = torch.zeros_like(send)
    if n == 1:
        return recv
    peer_to, peer_from = (s - 1, s + 1) if to_prev else (s + 1, s - 1)
    ops = []
    send = send.contiguous()
    if 0 <= peer_to < n:
        ops.append(dist.P2POp(dist.isend, send, mesh.seq_ranks[peer_to], mesh.seq_group))
    if 0 <= peer_from < n:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.seq_ranks[peer_from], mesh.seq_group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _left_halo(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Each shard receives the last ``halo`` samples of its left neighbour
    (zeros for shard 0)."""
    return _exchange(x[..., x.shape[-1] - halo:], False, mesh)


def _right_halo(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """Each shard receives the first ``halo`` samples of its right neighbour
    (zeros for the last shard)."""
    return _exchange(x[..., :halo], True, mesh)


def sharded_frames_left_halo(local: torch.Tensor, frame_len: int, hop: int,
                             mesh) -> torch.Tensor:
    """(..., Tl) time-shard -> (..., Tl/hop, frame_len) frames where global
    frame c covers samples [ (c+1)*hop - frame_len, (c+1)*hop )."""
    t = local.shape[-1]
    if t % hop != 0:
        raise ValueError(f"local shard length {t} must be a multiple of hop {hop}")
    left = _left_halo(local, frame_len - hop, mesh)
    full = torch.cat([left, local], dim=-1)
    return framing.frame_signal(full, frame_len, hop, t // hop)


def sharded_frames_right_halo(local: torch.Tensor, frame_len: int, hop: int,
                              mesh) -> torch.Tensor:
    """(..., Tl) time-shard -> (..., Tl/hop, frame_len) frames where global
    frame j starts at sample j*hop.  Frames overrunning the global signal end
    read zeros (mask downstream per speechpy counts)."""
    t = local.shape[-1]
    if t % hop != 0:
        raise ValueError(f"local shard length {t} must be a multiple of hop {hop}")
    right = _right_halo(local, frame_len - hop, mesh)
    full = torch.cat([local, right], dim=-1)
    return framing.frame_signal(full, frame_len, hop, t // hop)


def sharded_stft_vorbis_power(local: torch.Tensor, cfg: FeatureConfig, mesh) -> torch.Tensor:
    """Time-sharded vorbis STFT power: per-shard output rows are the global
    computed frames owned by this shard (chunk-indexed; the n_pad warm-up/
    tail layout is a global-view concern applied after gathering)."""
    frames = sharded_frames_left_halo(local, cfg.fft_points, cfg.stream_hop, mesh)
    xr, xi = rdft(frames, cfg, windowed=True)
    return (xr * xr + xi * xi) * (cfg.wnorm * cfg.wnorm)


def sharded_power_spectrum(local: torch.Tensor, cfg: FeatureConfig, mesh) -> torch.Tensor:
    """Time-sharded speechpy power spectrum over hop-strided frames of
    cfg.frame_size.  Requires cfg.frame_size % cfg.frame_step == 0 for a
    halo that is a whole number of hops."""
    frames = sharded_frames_right_halo(local, cfg.frame_size, cfg.frame_step, mesh)
    xr, xi = rdft(frames, cfg, windowed=cfg.window != "rect")
    return (xr * xr + xi * xi) * (1.0 / cfg.fft_points)
