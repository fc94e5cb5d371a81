"""Data-parallel (+ optional sequence-parallel) feature extraction.

The multi-device step of the corpus path: every rank of a (data, seq) mesh
(:mod:`.mesh`) calls :func:`extraction_step` with the same global host
arrays, takes its own block, extracts its features and all-reduces masked
corpus CMVN moments over the mesh (SPMD; the distributed generalization of
the reference's single-matrix ``cmvn``).

* batch rows are sharded over ``data`` (utterances are independent),
* the time axis optionally over ``seq``, with a ``frame_len - hop`` halo
  exchanged between neighbours (:mod:`.halo`),
* the filterbank/DCT constants are cached tensors on every rank's device,
* per-utterance ragged lengths are handled by frame-validity masks, so the
  moments exactly match unpadded statistics.

On a CUDA float32 shard the single-feature ``"mfcc"`` step runs the fused
MFCC kernel (``ops/cuda/speechpy_mfcc``) on the halo-extended shard; every
other head runs the plain chunk-GEMM on cuBLAS.

Results stay on each rank: features and mask are this rank's (Bl, Fl, ...)
block, packed outputs this data rank's valid frames.  :func:`fetch_outputs`
gathers them onto the mesh's rank 0 in the global layout (rows in corpus
order) and brings them to the host in one copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as tF
import torch.utils._pytree as pytree

from .. import features as F
from ..config import FeatureConfig, fp32_matmul
from ..constants import bundle_tensor
from ..ops import framing as _framing
from ..ops.mel import apply_filterbank
from ..ops.spectrum import zero_handling
from ..ops.ssc import ssc_from_power
from . import halo
from .mesh import DATA_AXIS, SEQ_AXIS, data_seq_sharding, data_sharding
from .stats import CorpusMoments, local_moments, psum_moments


def _n_valid_frames(lengths: torch.Tensor, cfg: FeatureConfig, feature) -> torch.Tensor:
    """Per-row valid output-frame count from the true sample counts, in
    exact integer arithmetic — the device twin of :func:`frame_counts_host`
    (both integer, so they agree bitwise)."""
    lengths = lengths.to(torch.int64)
    if feature == "melspec":
        hop = cfg.stream_hop
        # chunks = ceil(L / hop); lengths are non-negative sample counts
        return torch.div(lengths + (hop - 1), hop, rounding_mode="floor")
    # speechpy zero_padding=False count: floor((L - frame_len) / hop)
    return torch.div(lengths - cfg.frame_size, cfg.frame_step, rounding_mode="floor")


def _frame_mask(lengths, cfg, feature, n_local: int, mesh) -> torch.Tensor:
    """(Bl, Fl) validity of this shard's frames; the global frame index is
    ``seq_idx * n_local + arange``."""
    gidx = mesh.coords[1] * n_local + torch.arange(n_local, device=lengths.device)
    return gidx[None, :] < _n_valid_frames(lengths, cfg, feature)[:, None]


def _extended(signals: torch.Tensor, cfg: FeatureConfig, mesh) -> torch.Tensor:
    """The shard with its right halo (the next shard's first
    ``frame_len - hop`` samples, zeros at the row's end)."""
    halo_len = min(cfg.frame_size, cfg.fft_points) - cfg.frame_step
    right = halo._right_halo(signals, halo_len, mesh)
    return torch.cat([signals, right], dim=-1)


def _mfcc_kernel_head(full: torch.Tensor, cfg: FeatureConfig, n_local: int) -> torch.Tensor:
    """MFCC of the n_local frames of one halo-extended shard through
    :func:`..features.mfcc`, which on a CUDA float32 tensor (``pallas`` not
    "off") is one launch of the fused kernel.  Preemphasis runs here on the
    extended shard, as the chunk-GEMM step applies it.  speechpy's count
    ``floor((L - fl) / hop)`` leaves out the last frame that fits, so one
    hop of zeros that no kept frame reads makes it n_local."""
    if cfg.preemphasis_cof:
        full = _framing.preemphasis(full, 1, cfg.preemphasis_cof)
        cfg = cfg.replace(preemphasis_cof=0.0)
    need = n_local * cfg.frame_step + cfg.frame_size
    feats = F.mfcc(tF.pad(full, (0, need - full.shape[-1])), cfg)
    if feats.shape[-2] != n_local:
        raise RuntimeError(f"MFCC gave {feats.shape[-2]} frames for a shard of {n_local}")
    return feats


def _local_features(
    signals: torch.Tensor,
    lengths: torch.Tensor,
    cfg: FeatureConfig,
    feature: str,
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor, CorpusMoments]:
    """Per-shard body: (Bl, Tl) signals + (Bl,) int lengths -> (feats, mask,
    all-reduced moments)."""
    if feature == "melspec":
        return _local_melspec(signals, lengths, cfg, mesh)
    hop = cfg.frame_step
    n_local = signals.shape[-1] // hop
    mask = _frame_mask(lengths, cfg, feature, n_local, mesh)

    if feature not in ("mfcc", "lmfe", "mfe", "ssc"):
        raise ValueError(f"unknown feature {feature!r}")
    fast = F._fast_path_ok(cfg) and cfg.window == "rect"

    if feature == "ssc":
        full = _extended(signals, cfg, mesh)
        if fast:
            num, _, den = F._chunked_mel_energy(full, cfg, want_energy=False, ssc=True,
                                                n_frames=n_local)
            feats = num / den
        else:
            power = halo.sharded_power_spectrum(signals, cfg, mesh)
            feats = ssc_from_power(power, cfg)
    elif fast:
        # the single-device lowerings on the halo-extended local shard
        full = _extended(signals, cfg, mesh)
        if feature == "mfcc":
            feats = _mfcc_kernel_head(full, cfg, n_local)
        else:
            feats, _ = F._chunked_mel_energy(full, cfg, want_energy=True, n_frames=n_local)
            if feature == "lmfe":
                feats = torch.log(feats)
    else:
        power = halo.sharded_power_spectrum(signals, cfg, mesh)
        energies = zero_handling(torch.sum(power, dim=-1))
        feats = apply_filterbank(power, cfg, handle_zeros=True)
        if feature in ("mfcc", "lmfe"):
            logm = torch.log(feats)
            feats = logm
            if feature == "mfcc":
                dct = bundle_tensor(cfg, "dct", logm.device, logm.dtype)
                feats = F._cepstra(logm, energies, dct, cfg)

    moments = psum_moments(local_moments(feats, mask.to(feats.dtype)), mesh)
    return feats, mask, moments


def _local_multi(signals: torch.Tensor, lengths: torch.Tensor, cfg: FeatureConfig,
                 features: Tuple[str, ...], mesh):
    """Multi-feature shard body: ONE halo exchange + ONE chunk-GEMM frontend
    pass feeds every requested feature head (the sharded form of
    :func:`..features.extract`; its mfcc head is the chunk-GEMM, never the
    kernel).  Returns (dict of feats, mask, dict of all-reduced moments)."""
    unknown = set(features) - set(F.EXTRACT_HEADS)
    if unknown:
        raise ValueError(
            f"unknown features {sorted(unknown)}; valid: {sorted(F.EXTRACT_HEADS)}"
        )
    want = set(features)
    hop = cfg.frame_step
    n_local = signals.shape[-1] // hop
    mask = _frame_mask(lengths, cfg, features[0], n_local, mesh)

    need_energy = bool(want & {"mfe", "energy"}) or ("mfcc" in want and cfg.dc_elimination)
    if F._fast_path_ok(cfg) and cfg.window == "rect":
        full = _extended(signals, cfg, mesh)
        if cfg.preemphasis_cof:
            full = _framing.preemphasis(full, 1, cfg.preemphasis_cof)
        c = F._speechpy_tensors(cfg, full.device, full.dtype)
        ch, y = F._chunk_gemm(full, c["wall"], n_local, hop)
        out = F._extract_heads(ch, y, c, cfg, want, n_local, need_energy)
    else:
        power = halo.sharded_power_spectrum(signals, cfg, mesh)
        energies = zero_handling(torch.sum(power, dim=-1))
        mel = (apply_filterbank(power, cfg, handle_zeros=True)
               if want & {"mfcc", "lmfe", "mfe"} else None)
        dct = bundle_tensor(cfg, "dct", power.device, power.dtype)
        out = F._mel_heads(mel, energies, dct, cfg, want)
        if "ssc" in want:
            out["ssc"] = ssc_from_power(power, cfg)

    fmask = mask.to(signals.dtype)
    moments = {}
    for name in features:
        val = out[name][0] if name == "mfe" else out[name]
        if name == "energy":
            val = val[..., None]  # (Bl, Fl) -> (Bl, Fl, 1) for moment shape
        moments[name] = psum_moments(local_moments(val, fmask), mesh)
    return out, mask, moments


def _local_melspec(signals: torch.Tensor, lengths: torch.Tensor, cfg: FeatureConfig, mesh):
    """Sharded vorbis mel spectrogram: left-halo streaming frames, the
    trimmed windowed-DFT chunk-GEMM, mel projection.  Output is frame-major
    (Bl, Fl, M), chunk-indexed: the batch n_pad warm-up/tail layout is a
    global-view concern applied after gathering
    (:func:`..ops.stft._apply_npad_layout`)."""
    hop = cfg.stream_hop
    t = signals.shape[-1]
    if t % hop != 0:
        raise ValueError(f"local shard length {t} must be a multiple of hop {hop}")
    n_local = t // hop
    mask = _frame_mask(lengths, cfg, "melspec", n_local, mesh)
    # the left halo supplies the analysis memory; the hop-padded vorbis wall
    # makes the frames a shifted-chunk GEMM (as features.mel_spectrogram)
    c = F._vorbis_tensors(cfg, signals.device, signals.dtype)
    left = halo._left_halo(signals, cfg.fft_points - hop, mesh)
    full = torch.cat([left, signals], dim=-1)
    _, y = F._chunk_gemm(full, c["wall"], n_local, hop)
    with fp32_matmul():
        mel = torch.matmul(y * y, c["fb2"])
    moments = psum_moments(local_moments(mel, mask.to(mel.dtype)), mesh)
    return mel, mask, moments


def _unpack_local(flat: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
                  t_local: int, dtype: torch.dtype, seq_idx: int = 0) -> torch.Tensor:
    """Rebuild this shard's (Bl, t_local) signal block from the flat sample
    buffer on the device.

    ``flat`` holds every utterance's TRUE samples back to back (no padding)
    as int16 PCM or float32; row b of the padded batch is
    ``flat[offsets[b] : offsets[b] + lengths[b]]`` with zeros after.  The
    index arithmetic is int64."""
    pos = seq_idx * t_local + torch.arange(t_local, dtype=torch.int64,
                                           device=flat.device)[None, :]
    idx = torch.clamp(offsets[:, None] + pos, max=flat.shape[0] - 1)
    x = flat[idx]
    if x.dtype == torch.int16:
        # exact for PCM16 decode: i/32768 is a power-of-two scale
        x = x.to(dtype) * (1.0 / 32768.0)
    else:
        x = x.to(dtype)
    return torch.where(pos < lengths[:, None], x, torch.zeros((), dtype=dtype, device=x.device))


def _as_int32(arr, what: str):
    """Checked int32 narrowing for host index/length arrays: values past
    int32 are rejected, never wrapped.  A tensor passes through as it is."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.size and int(a.max(initial=0)) >= 2**31:
        raise ValueError(
            f"{what} {int(a.max())} exceeds int32 (split the batch or cap clip lengths)"
        )
    return a.astype(np.int32)


def frame_counts_host(lengths, cfg: FeatureConfig, feature) -> np.ndarray:
    """Host mirror of the device frame-validity mask's per-row counts
    (:func:`_n_valid_frames`): the number of valid output frames for each
    true sample count, in exact integer arithmetic; lengths past int32 are
    rejected rather than silently wrapped."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size and int(lengths.max()) >= 2**31:
        raise ValueError(
            f"clip length {int(lengths.max())} exceeds int32 samples"
        )
    if feature == "melspec":
        return np.maximum(-(-lengths // cfg.stream_hop), 0)
    return np.maximum((lengths - cfg.frame_size) // cfg.frame_step, 0)


def _all_gather_time(x: torch.Tensor, mesh) -> torch.Tensor:
    """(Bl, Fl, ...) seq blocks of one data row -> (Bl, n_seq*Fl, ...) on
    every rank of the row."""
    if mesh.shape[SEQ_AXIS] == 1:
        return x
    return torch.cat(_collect(x, mesh.seq_group, mesh.shape[SEQ_AXIS]), dim=1)


def _wire_view(x: torch.Tensor) -> torch.Tensor:
    """The bytes of x as a flat uint8 tensor: collectives that only move
    data carry every dtype this way (gloo has no bool or bfloat16)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _collect(x: torch.Tensor, group, n: int, dst=None):
    """All-gather (``dst`` None) or gather onto global rank ``dst`` of equal
    shaped tensors over ``group``, moved as bytes.  Returns the n tensors in
    group-rank order (None off ``dst`` for a gather)."""
    wire = _wire_view(x)
    bufs = [torch.empty_like(wire) for _ in range(n)]
    if dst is None:
        dist.all_gather(bufs, wire, group=group)
    else:
        me = dist.get_rank() == dst
        dist.gather(wire, bufs if me else None, dst=dst, group=group)
        if not me:
            return None
    return [b.view(x.dtype).reshape(x.shape) for b in bufs]


def _frame_pack_args(frame_counts):
    """(host exclusive-cumsum frame offsets, total valid frames) of the
    batch's per-row frame counts.  The cumsum runs in int64 and is narrowed
    through :func:`_as_int32`: counts summing to 2**31 or more raise instead
    of wrapping.  The port's packed buffers hold exactly the valid frames:
    eager PyTorch has no compiled shapes to keep few, so there is no
    bucketed zero tail."""
    counts = np.asarray(frame_counts, dtype=np.int64)
    incl = _as_int32(np.cumsum(counts), "frame offset").astype(np.int64)
    offs = np.zeros(counts.shape[0], dtype=np.int64)
    offs[1:] = incl[:-1]
    return offs, int(incl[-1]) if incl.size else 0


def _pack_frame_tree(feats, lengths: torch.Tensor, frame_offs: np.ndarray, total: int,
                     cfg: FeatureConfig, feature, mesh):
    """Epilogue of the packed-output step on one data rank: gather every
    VALID frame row of this rank's padded (Bl, F, ...) feature leaves into
    dense (n, ...) buffers, in (row-major, frame-major) corpus order, with
    frame offsets starting at 0.  Where the time axis is sharded, the data
    row first all-gathers its feature blocks along time.  ``frame_offs`` and
    ``total`` are the batch's global offsets and valid-frame count
    (:func:`_frame_pack_args`)."""
    feats = pytree.tree_map(lambda x: _all_gather_time(x, mesh), feats)
    any_leaf = pytree.tree_leaves(feats)[0]
    bl, f = any_leaf.shape[0], any_leaf.shape[1]
    d = mesh.coords[0]
    ends = np.append(frame_offs[1:], total)
    mine = frame_offs[d * bl:(d + 1) * bl]
    counts = ends[d * bl:(d + 1) * bl] - mine
    n = int(counts.sum())
    dev = any_leaf.device
    both = _upload(np.concatenate([counts, mine - mine[0]]), dev)
    c, offs = both[:bl], both[bl:]
    row = torch.repeat_interleave(torch.arange(bl, device=dev), c, output_size=n)
    fr = torch.arange(n, device=dev) - offs[row]
    nv = torch.clamp(_n_valid_frames(lengths, cfg, feature), 0, f)
    valid = fr < nv[row]
    flat_idx = row * f + torch.clamp(fr, 0, f - 1)

    def pk(leaf):
        g = leaf.reshape((bl * f,) + leaf.shape[2:])[flat_idx]
        v = valid.reshape((n,) + (1,) * (g.ndim - 1))
        return torch.where(v, g, torch.zeros((), dtype=g.dtype, device=g.device))

    return pytree.tree_map(pk, feats)


_WIRE_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}
_WIRE16 = (torch.float16, torch.bfloat16)


def _cast_wire(tree, wire_dtype):
    """Reduced-precision WIRE format for the packed-output fetch: quantize
    every f32 feature leaf to ``wire_dtype`` (float16/bfloat16) on device,
    halving the device->host bytes.  Exactly the round-to-nearest-even cast
    of the f32 result; f16 carries an 11-bit mantissa, so the feature error
    bound is ``|err| <= 2^-11 * |x|`` (+ subnormal floor)."""
    if wire_dtype is None:
        return tree
    wd = _WIRE_DTYPES[str(wire_dtype)]
    return pytree.tree_map(lambda x: x.to(wd) if x.dtype == torch.float32 else x, tree)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to a CUDA device through pinned memory,
    asynchronously (the copy does not wait for the work already queued)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _host_ints(mesh, *arrays) -> list:
    """This data rank's rows of each (B,) host int array, shipped to the
    device in ONE copy as int64."""
    rows = [data_sharding(mesh).block(np.asarray(a)) for a in arrays]
    both = _upload(np.concatenate(rows).astype(np.int64), mesh.device)
    return list(torch.split(both, [len(r) for r in rows]))


def _check_step(feature, cfg: FeatureConfig, mesh, b: int, t: int):
    """Validate a step's shapes; returns (cfg, feature key)."""
    multi = isinstance(feature, (tuple, list))
    if multi and "melspec" in feature:
        raise ValueError("melspec (vorbis hop/framing) cannot join a multi-feature pass")
    if feature == "melspec":
        if cfg.window != "vorbis":
            cfg = cfg.replace(window="vorbis")
        hop = cfg.stream_hop
    else:
        hop = cfg.frame_step
        if cfg.frame_size < hop:
            # the halo (frame_len - hop samples) would be negative
            raise ValueError("sequence-parallel framing requires frame_size >= frame_step")
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    if b % n_data:
        raise ValueError(f"batch {b} not divisible by data axis {n_data}")
    if t % (n_seq * hop):
        raise ValueError(f"time {t} not divisible by seq axis * hop = {n_seq * hop}")
    return cfg, tuple(feature) if multi else feature


def _run_local(signals, lengths, cfg, key, mesh, frame_counts, wire_dtype):
    """Shared body of both steps on this rank's signal block."""
    if frame_counts is None and wire_dtype is not None:
        raise ValueError("wire_dtype requires packed outputs (frame_counts)")
    if isinstance(key, tuple):
        feats, mask, moments = _local_multi(signals, lengths, cfg, key, mesh)
    else:
        feats, mask, moments = _local_features(signals, lengths, cfg, key, mesh)
    if frame_counts is None:
        return feats, mask, moments
    offs, total = _frame_pack_args(frame_counts)
    packed = _pack_frame_tree(feats, lengths, offs, total, cfg, key, mesh)
    return _cast_wire(packed, wire_dtype), moments


def _flat_tensor(flat, mesh) -> torch.Tensor:
    if isinstance(flat, torch.Tensor):
        return flat.to(mesh.device)
    return _upload(flat, mesh.device)


def extraction_step_packed(flat, offsets, lengths, t: int, cfg: FeatureConfig, mesh,
                           feature="mfcc", frame_counts=None, wire_dtype=None):
    """:func:`extraction_step` with the packed host->device layout from
    :func:`pack_signals`: this rank's padded (Bl, Tl) signal block is
    rebuilt ON DEVICE from the unpadded flat buffer (a host array, or a
    tensor already on the mesh's device), so the transfer carries only true
    samples (int16 when lossless).  Same outputs as extraction_step.

    ``frame_counts`` (per-row valid-frame counts from
    :func:`frame_counts_host`) switches on PACKED OUTPUTS: the return value
    becomes ``(packed_feats_tree, moments)`` where each feature leaf is a
    dense (n, ...) buffer of only this data rank's valid frames in row-major
    corpus order.  ``wire_dtype`` ("float16"/"bfloat16", packed outputs
    only) quantizes the feature leaves on device before the fetch — see
    :func:`_cast_wire` for the error bound.  Moments stay f32."""
    cfg, key = _check_step(feature, cfg, mesh, len(offsets), t)
    t_local = t // mesh.shape[SEQ_AXIS]
    flat_t = _flat_tensor(flat, mesh)
    offs_l, lens_l = _host_ints(mesh, _as_int32(offsets, "packed offset"),
                                _as_int32(lengths, "clip length"))
    signals = _unpack_local(flat_t, offs_l, lens_l, t_local, getattr(torch, cfg.dtype),
                            mesh.coords[1])
    return _run_local(signals, lens_l, cfg, key, mesh, frame_counts, wire_dtype)


def extraction_step(signals, lengths, cfg: FeatureConfig, mesh, feature="mfcc",
                    frame_counts=None, wire_dtype=None):
    """Sharded batch extraction + global masked moments.

    signals: (B, T) host array or tensor with B % n_data == 0 and
    T % (n_seq * hop) == 0 — or, as :func:`unpack_resample` returns it,
    this rank's (B / n_data, T) row block on the mesh's device; lengths:
    (B,) true sample counts.  Every rank of the mesh calls it with the same
    arguments.  Returns this rank's (features (Bl, Tl//hop, D), mask
    (Bl, Tl//hop)) block and the CorpusMoments all-reduced over the mesh.

    ``feature`` may also be a tuple/list of framed-family names ("mfcc",
    "lmfe", "mfe", "ssc", "energy"): ONE halo exchange + ONE chunk-GEMM
    frontend then feeds every head (the sharded
    :func:`..features.extract`), returning ({name: feats}, mask,
    {name: CorpusMoments}).

    ``frame_counts`` switches on packed outputs — see
    :func:`extraction_step_packed`."""
    b = len(lengths)
    cfg, key = _check_step(feature, cfg, mesh, b, signals.shape[-1])
    rows_local = signals.shape[0] != b
    if rows_local and signals.shape[0] * mesh.shape[DATA_AXIS] != b:
        raise ValueError(f"signals of {signals.shape[0]} rows for a batch of {b}")
    if rows_local:  # already this data rank's rows: take the time block
        tl = signals.shape[-1] // mesh.shape[SEQ_AXIS]
        block = signals[:, mesh.coords[1] * tl:(mesh.coords[1] + 1) * tl]
    else:
        block = data_seq_sharding(mesh).block(signals)
    block = block.to(mesh.device) if isinstance(block, torch.Tensor) else _upload(block, mesh.device)
    (lens_l,) = _host_ints(mesh, _as_int32(lengths, "clip length"))
    return _run_local(block, lens_l, cfg, key, mesh, frame_counts, wire_dtype)


def unpack_resample(flat, offsets, lengths_src, t_src: int, up: int, down: int, mesh):
    """Device entry for the packed mixed-rate path: unpack this data rank's
    rows of the flat buffer to a padded (Bl, t_src) float32 block and
    polyphase-resample it by up/down in one pass, so the host->device copy
    carries only the packed source-rate samples.  Returns this rank's
    (B / n_data, t_src*up//down) rows on the mesh's device, the form
    :func:`extraction_step` takes."""
    from ..ops.resample import resample_poly

    flat_t = _flat_tensor(flat, mesh)
    offs_l, lens_l = _host_ints(mesh, _as_int32(offsets, "packed offset"),
                                _as_int32(lengths_src, "clip length"))
    sig = _unpack_local(flat_t, offs_l, lens_l, t_src, torch.float32)
    return resample_poly(sig, up, down)


def pack_signals(clips, b_pad: int, mesh=None, flat_align: int = 2048, pcm16_exact=None):
    """Host-side packing for :func:`extraction_step_packed`: concatenate the
    clips' true samples into one flat buffer (int16 when every clip is
    exactly PCM16-representable, float32 otherwise), with per-row offsets.

    ``pcm16_exact``: loader-provided provenance
    (:class:`..runtime.loader.ClipMeta.pcm16_exact`).  ``True`` means every
    sample is already on the i/32768 grid, so requantization is a single
    exact multiply-and-cast; ``False`` skips int16 packing; ``None`` (no
    metadata) falls back to verifying every sample.

    Returns (flat, offsets (b_pad,), lengths (b_pad,)).  The flat buffer is
    zero-padded up to a multiple of ``flat_align``; rows past ``len(clips)``
    get offset 0 / length 0 (fully masked)."""
    lengths = np.zeros(b_pad, dtype=np.int64)
    offsets = np.zeros(b_pad, dtype=np.int64)
    total = 0
    for r, c in enumerate(clips):
        offsets[r] = total
        lengths[r] = len(c)
        total += len(c)
    n_flat = ((total + flat_align - 1) // flat_align) * flat_align
    n_flat = max(n_flat, flat_align)
    if pcm16_exact:
        # grid samples are i/32768 with |i| <= 32767: the f32 product is the
        # exact integer, so the cast is lossless — one pass, no verify
        flat = np.zeros(n_flat, dtype=np.int16)
        for r, c in enumerate(clips):
            np.multiply(
                c, np.float32(32768.0),
                out=flat[offsets[r]: offsets[r] + len(c)], casting="unsafe",
            )
        return flat, offsets, lengths
    exact = False
    if pcm16_exact is None:
        # no provenance: int16 is exact iff every sample sits on i/32768
        q_clips = []
        exact = True
        for c in clips:
            q = np.rint(np.asarray(c, np.float32) * 32768.0)
            if (np.abs(q) > 32767).any() or not np.array_equal(
                q.astype(np.float32) / np.float32(32768.0), np.asarray(c, np.float32),
            ):
                exact = False
                break
            q_clips.append(q.astype(np.int16))
    if exact:
        flat = np.zeros(n_flat, dtype=np.int16)
        for off, q in zip(offsets, q_clips):
            flat[off: off + len(q)] = q
    else:
        flat = np.zeros(n_flat, dtype=np.float32)
        for r, c in enumerate(clips):
            flat[offsets[r]: offsets[r] + len(c)] = c
    return flat, offsets, lengths


# ------------------------------------------------------------- outputs --
def _gather_rows(x: torch.Tensor, mesh):
    """Concatenate the data ranks' (n_d, ...) packed buffers on the mesh's
    rank 0, in rank order (the ranks of seq column 0 take part)."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return x
    root = int(mesh.devices[0, 0])
    size = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [int(s.item()) for s in _collect(size, mesh.data_group, n)]
    big = max(sizes)
    pad = torch.zeros((big - x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    parts = _collect(torch.cat([x, pad]), mesh.data_group, n, dst=root)
    if parts is None:
        return None
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def _gather_blocks(x: torch.Tensor, mesh):
    """Assemble the mesh's (Bl, Fl, ...) blocks into the global (B, F, ...)
    array on the mesh's rank 0."""
    x = _all_gather_time(x, mesh)
    if mesh.shape[DATA_AXIS] == 1 or mesh.coords[1] != 0:
        return x  # the root's row (n_data 1), or a column that has no part
    parts = _collect(x, mesh.data_group, mesh.shape[DATA_AXIS], dst=int(mesh.devices[0, 0]))
    return None if parts is None else torch.cat(parts)


def gather_outputs(out, mesh):
    """One step's outputs on every rank -> the global layout on the mesh's
    rank 0 (None elsewhere): ``(feats, mask, moments)`` blocks become the
    (B, F, ...) arrays, a packed ``(feats, moments)`` the data ranks' valid
    frames in corpus order.  Moments are already all-reduced.  Every rank of
    the mesh must call it, in the same order as its other collectives."""
    if mesh is None or mesh.size == 1:
        return out
    if mesh.coords[1] != 0 and len(out) == 2:
        return None  # seq column 0 holds the row's packed frames
    gather = _gather_blocks if len(out) == 3 else _gather_rows
    leaves = pytree.tree_map(lambda x: gather(x, mesh), tuple(out[:-1]))
    if not mesh.is_root:
        return None
    return (*leaves, out[-1])


def _wire_slots(leaf) -> int:
    """f32 slots a leaf occupies in the packed wire buffer: 16-bit leaves
    ride two-per-slot (bit pairs), everything else one value per slot."""
    n = leaf.numel()
    return (n + 1) // 2 if leaf.dtype in _WIRE16 else n


def _pack_leaves(leaves) -> torch.Tensor:
    parts = []
    for x in leaves:
        v = x.reshape(-1)
        if v.dtype in _WIRE16:
            # two 16-bit values per f32 wire slot: pad to even, view the
            # pairs as f32 — pure bit transport, the host views them back
            if v.numel() % 2:
                v = torch.cat([v, v.new_zeros(1)])
            parts.append(v.contiguous().view(torch.float32))
        else:
            parts.append(v.to(torch.float32))
    return torch.cat(parts)


def _host_leaf(x: torch.Tensor):
    """A leaf on the host: numpy, except bfloat16 (which numpy lacks), a CPU
    tensor."""
    x = x.detach().cpu()
    return x if x.dtype == torch.bfloat16 else x.numpy()


def fetch_outputs(tree, mesh=None):
    """Device->host fetch of an output tree in ONE transfer: every leaf is
    flattened into one float32 buffer (16-bit leaves two to a slot), copied
    once and split on the host.  Falls back to one copy per leaf when a leaf
    would not survive the f32 round trip (float64 runs) or there is only
    one.  Leaves come back as numpy arrays (bfloat16 ones as CPU tensors).

    With a multi-rank ``mesh``, ``tree`` is a list of step outputs: they are
    gathered onto the mesh's rank 0 first (:func:`gather_outputs`; every
    rank calls this), which alone gets the host tree — the others None."""
    if mesh is not None and mesh.size > 1:
        tree = [gather_outputs(o, mesh) for o in tree]
        if not mesh.is_root:
            return None
    leaves, spec = pytree.tree_flatten(tree)
    safe = all(l.dtype in (torch.float32, torch.bool) + _WIRE16 for l in leaves)
    if not safe or len(leaves) < 2:
        return pytree.tree_unflatten([_host_leaf(l) for l in leaves], spec)
    flat = _pack_leaves(leaves).cpu().numpy()  # the single copy
    out = []
    ofs = 0
    for l in leaves:
        n = l.numel()
        slots = _wire_slots(l)
        part = flat[ofs: ofs + slots]
        if l.dtype == torch.float16:
            out.append(part.view(np.float16)[:n].reshape(tuple(l.shape)))
        elif l.dtype == torch.bfloat16:
            bits = torch.from_numpy(part.view(np.int16)[:n].copy())
            out.append(bits.view(torch.bfloat16).reshape(l.shape))
        elif l.dtype == torch.bool:
            out.append(part.reshape(tuple(l.shape)).astype(bool))
        else:
            out.append(part.reshape(tuple(l.shape)))
        ofs += slots
    return pytree.tree_unflatten(out, spec)
