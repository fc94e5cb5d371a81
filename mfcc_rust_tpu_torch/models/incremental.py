"""Carried chunk-GEMM streaming front end (port of
``mfcc_rust_tpu.models.incremental``).

The recompute streaming path runs the framed pipeline again over an
``n_frames*hop + frame_len`` window on each call, so each hop-chunk meets
the DFT wall ``r = frame_len/hop`` times in its life.  Here each chunk is
multiplied once — ``g[s] = chunk @ wall_block_s`` for all r shift blocks in
one product — and the partial frame sums carry across calls: the streaming
form of the batch chunk-GEMM (``features._chunk_gemm``).  A call costs
O(new samples); the state is O(r) frame rows.

Accumulation order: within a frame, contributions are added in ascending
shift order, the order of the batch product's shifted form, so a session
fed in chunks gives the batch output up to the rounding of the products.

A feed's whole chunks go through the step in pieces of ``K_BUCKETS`` chunks
(greedy, largest first), as the JAX front end's jitted steps do: on a CUDA
session each piece replays the session's CUDA graph of its size
(:mod:`..utils.graphs`), at most four, and eagerly the same pieces run the
same products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import FeatureConfig, fp32_matmul
from ..constants import chunk_gemm_wall, constant_bundle
from ..features import _cepstra, _fast_path_ok, _stacked_fb
from ..ops.spectrum import zero_handling
from ..utils import graphs
from ..utils.device import resolve_device


def incremental_supported(cfg: FeatureConfig, feature: str) -> bool:
    """The carried front end serves (cfg, feature): no pre-emphasis, frames
    of whole hops, librosa frames of fft_points, and the speechpy families
    only on the chunk-GEMM path.

    Its emission clock moves a chunk at a time: frame f comes out once chunk
    f + r - 1 is in.  A frame that is not a whole number of hops is ready up
    to ``hop - fl % hop`` samples before that chunk ends, so under ragged
    feeds the batch count of the samples seen could run ahead of the
    emissions; such configs take the recompute path."""
    if cfg.preemphasis_cof:
        return False
    if cfg.frame_size % cfg.frame_step != 0:
        return False
    if feature == "mel_librosa":
        return cfg.frame_size == cfg.fft_points
    if feature in ("mfcc", "lmfe", "mfe"):
        return _fast_path_ok(cfg)
    return False


class IncrementalFrontend(nn.Module):
    """Carried-state streaming executor for one (cfg, feature) pair.

    ``feed(samples)`` returns the frame rows that the new whole chunks
    complete, in order (``None`` when no chunk completes); the caller keeps
    the sample count and decides which rows are real frames.  Constants are
    buffers (``_wcat``, the (hop, r*W) concatenated wall; ``_fb2``; ``_w2``;
    ``_dct``).  The carry — ``rem`` (< hop leftover samples), ``pending``
    ((P, W) partial product rows) and ``pending_e`` ((P,) partial energy
    sums) — is a set of plain tensors on the module's device.  ``pending``
    and ``pending_e`` are allocated once: the step updates them in place and
    :meth:`reset` zeroes them in place, since a replayed step reads and
    writes them at their addresses.

    Row layout: with C chunks consumed, the next row out is frame C - P,
    P = r - 1 + lag (lag 1 reproduces speechpy's one-frame emission lag,
    lag 0 librosa's emit-on-complete); rows of negative frames are warm-up,
    which the caller drops.
    """

    #: chunk counts of one step, split greedily largest first (zero chunks
    #: cannot pad a piece: they would advance the frame clock)
    K_BUCKETS = (64, 16, 4, 1)

    def __init__(self, cfg: FeatureConfig, feature: str, device=None):
        super().__init__()
        if not incremental_supported(cfg, feature):
            raise ValueError(f"incremental streaming unsupported for {feature!r}")
        self.cfg = cfg
        self.feature = feature
        dev = resolve_device(device)
        bundle = constant_bundle(cfg)
        self.lag = 0 if feature == "mel_librosa" else 1
        w2 = None
        if feature == "mel_librosa":
            kmax = bundle["fbank_kmax"]
            c64, s64 = bundle["dft_windowed"]
            fl = c64.shape[0]
            wall = np.zeros((-(-fl // cfg.frame_step) * cfg.frame_step, 2 * kmax))
            wall[:fl, :kmax] = c64[:, :kmax]
            wall[:fl, kmax:] = s64[:, :kmax]
            fb2 = _stacked_fb(bundle["fbank"], kmax, 2 * kmax)
            self._want_energy = False
        else:
            # the energy feeds mfe, and mfcc's dc-elimination column
            self._want_energy = feature == "mfe" or (feature == "mfcc" and cfg.dc_elimination)
            wd = chunk_gemm_wall(cfg, self._want_energy)
            wall, w2, kmax = wd["wall"], wd["w2"], wd["kmax"]
            fb2 = _stacked_fb(bundle["fbank"], kmax, wall.shape[1], 1.0 / cfg.fft_points)
        self._kmax = kmax
        self.hop = cfg.frame_step
        self.r = wall.shape[0] // self.hop
        self.P = self.r - 1 + self.lag
        self.W = wall.shape[1]
        # (hop, r*W): one product a chunk covers every shift block
        wcat = np.concatenate(
            [wall[s * self.hop:(s + 1) * self.hop] for s in range(self.r)], axis=1)
        dt = getattr(torch, cfg.dtype)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
        self.register_buffer("_wcat", t(wcat), persistent=False)
        self.register_buffer("_fb2", t(fb2), persistent=False)
        self.register_buffer("_w2", None if w2 is None else t(w2), persistent=False)
        self.register_buffer("_dct", t(bundle["dct"]), persistent=False)
        self.pending = self._wcat.new_zeros((self.P, self.W))
        self.pending_e = self._wcat.new_zeros((self.P,))
        self._graphs = graphs.GraphCache(share_pool=True)
        self.reset()

    def reset(self) -> None:
        """A fresh carry: no leftover samples, the partial sums zeroed in
        place."""
        self.rem = self._wcat.new_zeros(0)
        self.pending.zero_()
        self.pending_e.zero_()

    def feed(self, samples: torch.Tensor):
        """Consume (T,) samples on the module's device.  Returns the rows of
        the k chunks completed — (k, D), or for ``mfe`` the pair ((k, M),
        (k,)) — or ``None`` when no chunk completes.  Includes the warm-up
        rows of negative frames; the caller trims by its ready count."""
        buf = torch.cat([self.rem, samples])
        k = buf.shape[0] // self.hop
        self.rem = buf[k * self.hop:]
        if k == 0:
            return None
        chunks = buf[:k * self.hop].reshape(k, self.hop)
        eager = graphs.runs_eagerly(chunks, chunks.device)
        state = (self.pending, self.pending_e)
        outs, pos = [], 0
        while pos < k:
            kb = next(b for b in self.K_BUCKETS if b <= k - pos)
            piece = chunks[pos:pos + kb]
            if eager:
                outs.append(self._step(piece, *state))
            else:
                outs.append(self._graphs.run((), self._step, piece.shape, piece.dtype,
                                             piece.device, lambda s, p=piece: s.copy_(p),
                                             state=state))
            pos += kb
        if len(outs) == 1:
            return outs[0]
        if self.feature == "mfe":
            return tuple(torch.cat(p) for p in zip(*outs))
        return torch.cat(outs)

    @fp32_matmul()
    def _step(self, chunks: torch.Tensor, pending: torch.Tensor, pending_e: torch.Tensor):
        """The rows of (k, hop) chunks; ``pending`` and ``pending_e`` advance
        in place."""
        k, r, p = chunks.shape[0], self.r, self.P
        g = torch.matmul(chunks, self._wcat).reshape(k, r, self.W)
        acc = torch.cat([pending, chunks.new_zeros((k, self.W))])
        for s in range(r):  # ascending shift: the batch order
            acc[p - s:p - s + k] += g[:, s]
        y = acc[:k]
        pending.copy_(acc[k:])
        e = None
        if self._want_energy:
            # per-(chunk, shift) windowed sums of squares: the streaming form
            # of features._parseval_energies' per-chunk reductions
            ge = torch.matmul(chunks * chunks, self._w2.T)  # (k, r)
            acc_e = torch.cat([pending_e, chunks.new_zeros(k)])
            for s in range(r):
                acc_e[p - s:p - s + k] += ge[:, s]
            pending_e.copy_(acc_e[k:])
            n = self.cfg.fft_points
            s0, s1 = y[:, 2 * self._kmax], y[:, 2 * self._kmax + 1]
            e = zero_handling((n * acc_e[:k] + s0 * s0 + s1 * s1) / (2.0 * n))
        return self._head(y, e)

    def _head(self, y: torch.Tensor, e: Optional[torch.Tensor]):
        """The feature head on the k emitted product rows."""
        mel = torch.matmul(y * y, self._fb2)
        if self.feature == "mel_librosa":
            return mel
        mel = zero_handling(mel)
        if self.feature == "mfe":
            return mel, e
        logm = torch.log(mel)
        if self.feature == "lmfe":
            return logm
        return _cepstra(logm, e, self._dct, self.cfg)
