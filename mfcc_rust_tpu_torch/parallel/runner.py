"""Corpus extraction runner: streaming feature extraction over a corpus of
WAV files with checkpoint/resume and corpus CMVN.

The reference has no batch/corpus tooling at all.  This runner iterates a
corpus through the native prefetch loader, length-buckets it into batches,
extracts on the device mesh, writes per-utterance outputs idempotently,
accumulates corpus CMVN moments, and checkpoints (done-mask + moments) so a
killed job resumes without recompute.

One controller: the mesh's rank 0 alone runs the loader, the rate/bucket
pools and :func:`.data.pack_signals`, and broadcasts each batch over the
mesh's group (the flat sample buffer, then offsets, lengths, the bucket and
the utterance ids).  Every rank of the mesh extracts its block of the batch
(:func:`.data.extraction_step_packed`); rank 0 gathers the outputs, fetches
them, writes the files and saves the checkpoint.  Every rank of the mesh
constructs the runner and calls :meth:`CorpusRunner.run`; all return the
same moments.

Multi-host: each runner (one mesh) takes its slice of the file list
(``paths[process_index::process_count]``); per-batch moments are already
all-reduced across its mesh; runner-local running moments are checkpointed
and merged deterministically with :func:`.stats.tree_merge` (fixed
association order, :func:`merge_checkpoints`).
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import FeatureConfig
from ..ops.framing import speechpy_frame_counts
from ..utils.bucketing import bucket_length
from ..utils.profiling import Meter
from .data import _upload, _wire_view, gather_outputs
from .mesh import DATA_AXIS, SEQ_AXIS, make_mesh
from .stats import CorpusMoments, tree_merge


def _config_fingerprint(cfg: FeatureConfig, n_paths: int, dim) -> str:
    """Stable across processes: Python's hash() is salted per interpreter
    (PYTHONHASHSEED), which would make every cross-process resume fail.  The
    port's FeatureConfig has the reference's fields, so a checkpoint of
    either package's runner resumes in the other."""
    import dataclasses
    import hashlib

    blob = repr(sorted(dataclasses.asdict(cfg).items())).encode()
    return f"{hashlib.sha256(blob).hexdigest()[:16]}:{n_paths}:{dim}"


class CheckpointStore:
    """npz checkpoint: done mask + running moments + config fingerprint.

    ``dim`` is an int for a single feature, or a {feature_name: dim} dict for
    a multi-feature run — then ``moments`` is a matching dict and the npz
    holds per-feature ``count_<name>`` / ``mean_<name>`` / ``m2_<name>``
    arrays (legacy total/total_sq checkpoints load with a conversion)."""

    def __init__(self, path: str, n_paths: int, cfg: FeatureConfig, dim):
        self.path = Path(path)
        self.n_paths = n_paths
        self.multi = isinstance(dim, dict)
        self.fingerprint = _config_fingerprint(
            cfg, n_paths, repr(sorted(dim.items())) if self.multi else dim
        )
        self.done = np.zeros(n_paths, dtype=bool)
        if self.multi:
            self.moments = {k: CorpusMoments.zeros(d) for k, d in dim.items()}
        else:
            self.moments = CorpusMoments.zeros(dim)
        if self.path.exists():
            self._load()

    @staticmethod
    def _read_moments(z, suffix: str = "") -> CorpusMoments:
        # plain numpy: host-side moment accumulation never touches the device
        if "mean" + suffix in getattr(z, "files", z):
            return CorpusMoments(
                np.asarray(z["count" + suffix]),
                np.asarray(z["mean" + suffix]),
                np.asarray(z["m2" + suffix]),
            )
        # legacy (sum, sum_sq, count) checkpoint: convert to Welford form
        total = np.asarray(z["total" + suffix], np.float64)
        total_sq = np.asarray(z["total_sq" + suffix], np.float64)
        count = float(z["count" + suffix])
        mean = total / max(count, 1.0)
        m2 = np.maximum(total_sq - total * mean, 0.0)
        return CorpusMoments(np.float32(count), mean.astype(np.float32), m2.astype(np.float32))

    def _load(self) -> None:
        z = np.load(self.path, allow_pickle=False)
        if str(z["fingerprint"]) != self.fingerprint:
            raise ValueError(
                f"checkpoint {self.path} was written for a different "
                f"config/corpus ({z['fingerprint']} != {self.fingerprint})"
            )
        self.done = z["done"]
        if self.multi:
            self.moments = {k: self._read_moments(z, f"_{k}") for k in self.moments}
        else:
            self.moments = self._read_moments(z)

    def save(self) -> None:
        tmp = self.path.with_suffix(".tmp.npz")
        arrays = {}
        items = (
            [(f"_{k}", m) for k, m in self.moments.items()]
            if self.multi
            else [("", self.moments)]
        )
        for suffix, m in items:
            arrays["count" + suffix] = np.asarray(m.count)
            arrays["mean" + suffix] = np.asarray(m.mean)
            arrays["m2" + suffix] = np.asarray(m.m2)
        np.savez(tmp, fingerprint=self.fingerprint, done=self.done, **arrays)
        os.replace(tmp, self.path)

    def mark(self, indices: Sequence[int], moments) -> None:
        self.done[list(indices)] = True
        if self.multi:
            self.moments = {k: self.moments[k].merge(moments[k]) for k in self.moments}
        else:
            self.moments = self.moments.merge(moments)


def merge_checkpoints(paths: Sequence[str], dim: int,
                      features: Optional[Sequence[str]] = None):
    """Deterministic cross-host merge of per-host checkpoint moments.
    Pass ``features`` for multi-feature checkpoints; returns a dict then."""
    if features is not None:
        return {
            name: tree_merge([
                CheckpointStore._read_moments(np.load(p, allow_pickle=False), f"_{name}")
                for p in sorted(paths)
            ])
            for name in features
        }
    parts = []
    for p in sorted(paths):
        z = np.load(p, allow_pickle=False)
        parts.append(CheckpointStore._read_moments(z))
    return tree_merge(parts)


def _host_payload(x):
    """A fetched leaf as numpy for ``np.save``: a bfloat16 wire leaf (a CPU
    tensor; numpy has no bfloat16) is written as the float32 of the same
    values, which holds every bfloat16 exactly."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return x


class CorpusRunner:
    """Extract features for a corpus of WAV files on a device mesh.

    The constructor takes the reference's arguments with its defaults, plus
    ``device``, the device of the default mesh (None means CUDA; pass
    ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        paths: Sequence[str],
        cfg: Optional[FeatureConfig] = None,
        mesh=None,
        feature: str = "mfcc",
        batch_size: int = 32,
        out_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 8,
        process_index: int = 0,
        process_count: int = 1,
        n_io_threads: int = 4,
        max_seconds: float = 240.0,
        on_batch: Optional[Callable[[dict], None]] = None,
        resample: bool = False,
        fetch_every: int = 1,
        fetch_threads: int = 4,
        write_threads: int = 2,
        packed_output: bool = True,
        wire_dtype: Optional[str] = None,
        pool_growth: Optional[float] = None,
        device=None,
    ):
        self.all_paths = [str(p) for p in paths]
        # this runner's shard of the corpus
        self.indices = list(range(process_index, len(self.all_paths), process_count))
        self.max_seconds = max_seconds
        # Deterministic, collision-free output names in one explicit pass
        # over corpus-index order: the first file with a given stem keeps it;
        # later collisions take an index suffix, then trailing underscores
        # until unused.  The mapping depends only on the path list, so every
        # restart reproduces it and resume stays idempotent.
        self._out_names = {}
        used = set()
        for i, p in enumerate(self.all_paths):
            name = Path(p).stem
            if name in used:
                name = f"{name}_{i:06d}"
            while name in used:
                name += "_"
            used.add(name)
            self._out_names[i] = f"{name}.npy"
        self.cfg = cfg if cfg is not None else FeatureConfig(sample_rate=16000)
        self.mesh = mesh if mesh is not None else make_mesh(n_seq=1, device=device)
        # Multi-host model: each runner runs over its OWN file slice on its
        # OWN mesh (moments then all-reduce within it and the per-runner
        # checkpoint moments tree-merge to the corpus total).  A mesh whose
        # ranks belong to several runners would all-reduce every batch across
        # them and the checkpoint merge would double-count.
        if process_count > 1 and self.mesh.size > 1:
            mine = torch.tensor([process_index], dtype=torch.int64, device=self.mesh.device)
            seen = [torch.empty_like(mine) for _ in range(self.mesh.size)]
            dist.all_gather(seen, mine, group=self.mesh.group)
            if any(int(s.item()) != process_index for s in seen):
                raise ValueError(
                    "CorpusRunner with process_count > 1 requires a mesh whose "
                    "ranks all run this runner (make_mesh(group=...) per runner)"
                )
        self.multi = isinstance(feature, (tuple, list))
        self.feature = tuple(feature) if self.multi else feature
        self.batch_size = batch_size
        self.out_dir = Path(out_dir) if out_dir else None
        if self.out_dir and self.mesh.is_root:
            self.out_dir.mkdir(parents=True, exist_ok=True)

        def _feat_dim(name: str) -> int:
            if name == "mfcc":
                return self.cfg.num_cepstral
            if name == "energy":
                return 1
            return self.cfg.num_filters

        if self.multi:
            dim = {name: _feat_dim(name) for name in self.feature}
            # multi-feature outputs are .npz bundles, one array per feature
            self._out_names = {
                i: name[: -len(".npy")] + ".npz" for i, name in self._out_names.items()
            }
        else:
            dim = _feat_dim(feature)
        self.dim = dim
        # the checkpoint is rank 0's: it alone loads, marks and saves it
        self.store = (
            CheckpointStore(checkpoint_path, len(self.all_paths), self.cfg, dim)
            if checkpoint_path and self.mesh.is_root
            else None
        )
        self.checkpoint_every = checkpoint_every
        self.n_io_threads = n_io_threads
        self.meter = Meter()
        self.on_batch = on_batch
        # resample=True: files whose rate differs from cfg.sample_rate are
        # polyphase-resampled on device (per-batch, same-rate batches)
        # instead of raising
        self.resample = resample
        # Dispatch-ahead depth: up to ``fetch_every`` batches stay in flight
        # on the device and their outputs come back in ONE packed
        # device->host copy.  Results are consumed in dispatch order either
        # way, so moment merges stay bitwise deterministic.
        self.fetch_every = max(1, int(fetch_every))
        # Overlapped fetches: device->host copies of different groups run in
        # a small thread pool while the main thread keeps decoding and
        # dispatching.  Results are still CONSUMED (moments merged, outputs
        # written, checkpoint marked) strictly in dispatch order on the main
        # thread.  0 = fetch synchronously on the main thread.
        self.fetch_threads = max(0, int(fetch_threads))
        # Per-utterance .npy/.npz writes run in a small writer pool so file
        # I/O overlaps decode/dispatch/fetch.  Writes are flushed before
        # every checkpoint save, so "done" is never durable before its
        # outputs are.  0 = write synchronously.
        self.write_threads = max(0, int(write_threads))
        # Packed OUTPUT transfers: the device packs only the valid frames of
        # every feature head into dense buffers before the fetch, so the
        # device->host copy skips batch padding and the mask plane; the host
        # reconstructs per-utterance slices from frame_counts_host (exact
        # integer mirror of the device mask).
        self.packed_output = bool(packed_output)
        # Opt-in 16-bit feature WIRE ("float16"/"bfloat16"): quantizes the
        # packed output leaves on device before the fetch, halving its
        # bytes.  Lossy: outputs carry the 16-bit format's quantization and
        # float16 ones are written as float16.  Moments/CMVN stay f32.
        self.wire_dtype = wire_dtype
        if wire_dtype is not None and not self.packed_output:
            raise ValueError("wire_dtype requires packed_output=True")
        # pool_growth=None (default): batches pool per (rate, length bucket)
        # on the fine default grid — a 1 s clip never pads to a 35 s
        # neighbor.  A float (e.g. 2.5) pools on a COARSER geometric band
        # grid; each batch still dispatches at the fine bucket of its own
        # longest clip.  The (B, T) rebuild gather costs per PADDED element,
        # so coarse pools pay for their padding there.
        self.pool_growth = pool_growth

    # -------------------------------------------------------- broadcast --
    def _send(self, msg: dict, flat: Optional[torch.Tensor] = None) -> None:
        """Rank 0: broadcast one message (and its flat sample buffer) over
        the mesh's group."""
        obj = [msg]
        dist.broadcast_object_list(obj, src=int(self.mesh.devices[0, 0]),
                                   group=self.mesh.group, device=self.mesh.device)
        if flat is not None:
            dist.broadcast(_wire_view(flat), src=int(self.mesh.devices[0, 0]),
                           group=self.mesh.group)

    def _recv(self):
        """Other ranks: (message, flat buffer or None)."""
        obj = [None]
        dist.broadcast_object_list(obj, src=int(self.mesh.devices[0, 0]),
                                   group=self.mesh.group, device=self.mesh.device)
        msg = obj[0]
        if "n_flat" not in msg:
            return msg, None
        dtype = getattr(torch, msg["flat_dtype"])
        flat = torch.empty(msg["n_flat"], dtype=dtype, device=self.mesh.device)
        dist.broadcast(_wire_view(flat), src=int(self.mesh.devices[0, 0]),
                       group=self.mesh.group)
        return msg, flat

    def _step(self, msg: dict, flat: torch.Tensor):
        """Every rank: extract its block of one dispatched batch."""
        from .data import extraction_step, extraction_step_packed, unpack_resample

        if msg["kind"] == "batch":
            return extraction_step_packed(
                flat, msg["offsets"], msg["lengths"], msg["t"], self.cfg, self.mesh,
                self.feature, frame_counts=msg["counts"], wire_dtype=self.wire_dtype,
            )
        sig = unpack_resample(flat, msg["offsets"], msg["src_lengths"], msg["src_t"],
                              msg["up"], msg["down"], self.mesh)
        return extraction_step(sig, msg["lengths"], self.cfg, self.mesh, self.feature,
                               frame_counts=msg["counts"], wire_dtype=self.wire_dtype)

    def _follow(self) -> None:
        """A rank other than the mesh's 0: run every step rank 0 broadcasts
        and take part in its gathers, in the same order, until it stops."""
        inflight = []
        while True:
            msg, flat = self._recv()
            if msg["kind"] == "abort":
                raise RuntimeError(f"the mesh's rank 0 stopped: {msg['why']}")
            if msg["kind"] == "stop":
                break
            inflight.append(self._step(msg, flat))
            if len(inflight) >= self.fetch_every:
                for out in inflight:
                    gather_outputs(out, self.mesh)
                inflight.clear()
        for out in inflight:
            gather_outputs(out, self.mesh)

    # ------------------------------------------------------------------ run --
    def run(self) -> CorpusMoments:
        """Extract every file of this runner's slice not yet done; returns
        the running corpus moments (numpy), on every rank of the mesh."""
        if self.mesh.size == 1:
            return self._run_root()
        root = int(self.mesh.devices[0, 0])
        if not self.mesh.is_root:
            self._follow()
            obj = [None]
            dist.broadcast_object_list(obj, src=root, group=self.mesh.group,
                                       device=self.mesh.device)
            moments, why = obj[0]
            if why is not None:
                raise RuntimeError(f"the mesh's rank 0 stopped: {why}")
            return moments
        self._stopped = False
        try:
            moments = self._run_root()
        except BaseException as e:
            # the other ranks wait for a message (before the stop) or for
            # the result (after it): either way they learn of the failure
            if self._stopped:
                dist.broadcast_object_list([(None, repr(e))], src=root, group=self.mesh.group,
                                           device=self.mesh.device)
            else:
                self._send({"kind": "abort", "why": repr(e)})
            raise
        dist.broadcast_object_list([(moments, None)], src=root, group=self.mesh.group,
                                   device=self.mesh.device)
        return moments

    def _run_root(self):
        from ..runtime import AudioLoader

        multi_rank = self.mesh.size > 1
        todo = [i for i in self.indices if not (self.store is not None and self.store.done[i])]
        if self.store is not None:
            moments = self.store.moments
        elif self.multi:
            moments = {k: CorpusMoments.zeros(d) for k, d in self.dim.items()}
        else:
            moments = CorpusMoments.zeros(self.dim)
        if not todo:
            if multi_rank:
                self._send({"kind": "stop"})
                self._stopped = True
            return moments

        n_data = self.mesh.shape[DATA_AXIS]
        n_seq = self.mesh.shape[SEQ_AXIS]
        hop = self.cfg.stream_hop if self.feature == "melspec" else self.cfg.frame_step
        align = n_seq * hop
        dev = self.mesh.device

        # Reorder-buffer depth: the in-order loader can only run `capacity`
        # clips ahead of the consumer, but a batch dispatches only after
        # batch_size clips arrive; sizing it past one full batch lets decode
        # run ahead under the device/fetch time.
        loader = AudioLoader(
            [self.all_paths[i] for i in todo], n_threads=self.n_io_threads,
            max_seconds=self.max_seconds, capacity=max(32, 2 * self.batch_size),
        )
        # pending pools keyed by source sample rate: batches are same-rate so
        # one device resample call handles the whole padded batch
        pending: dict = {}
        batches_since_ckpt = 0
        # batches dispatched but not yet fetched, in dispatch order:
        # [(utt ids, output tree, audio seconds, counts)]
        inflight: List[tuple] = []
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pending_fetches: deque = deque()
        executor = None
        writer = None
        write_futures: List = []
        if self.fetch_threads:
            executor = ThreadPoolExecutor(self.fetch_threads, thread_name_prefix="corpus-fetch")
        if self.write_threads and self.out_dir:
            writer = ThreadPoolExecutor(self.write_threads, thread_name_prefix="corpus-write")
        max_pending = self.fetch_threads + 2

        def tree_bytes(tree) -> int:
            import torch.utils._pytree as pytree

            return sum(l.numel() * l.element_size() for l in pytree.tree_leaves(tree))

        def write_one(out_path: Path, payload) -> None:
            if out_path.exists():
                return  # idempotent restart-safe output
            if isinstance(payload, dict):
                tmp = out_path.with_suffix(".tmp.npz")
                np.savez(tmp, **{k: _host_payload(v) for k, v in payload.items()})
            else:
                tmp = out_path.with_suffix(".tmp.npy")
                np.save(tmp, _host_payload(payload))
            os.replace(tmp, out_path)

        def flush_writes() -> None:
            # durability barrier: all submitted outputs on disk (and any
            # writer exception re-raised) before a checkpoint can mark done
            nonlocal write_futures
            for f in write_futures:
                f.result()
            write_futures = []

        def send_and_step(msg: dict, flat: np.ndarray):
            # the batch's one host->device copy of samples; the other ranks
            # receive it by broadcast
            flat_t = _upload(flat, dev)
            if multi_rank:
                msg = dict(msg, n_flat=int(flat.shape[0]), flat_dtype=str(flat.dtype))
                self._send(msg, flat_t)
            return self._step(msg, flat_t)

        def dispatch(batch: List[tuple], src_rate: int):
            import math

            from .data import frame_counts_host, pack_signals

            ids = [todo[j] for j, _, _ in batch]
            # loader-metadata provenance: requantize losslessly without the
            # per-sample verify pass when every clip is mono PCM16
            exact = all(meta.pcm16_exact for _, _, meta in batch)
            b = len(batch)
            # partial tail batches round up to a power of two (then to the
            # data axis); padded rows carry length 0 -> fully masked
            b_pad = b if b >= self.batch_size else 1 << (b - 1).bit_length()
            b_pad = ((b_pad + n_data - 1) // n_data) * n_data
            src_lengths = np.array([len(s) for _, s, _ in batch], dtype=np.int64)
            with self.meter.measure(0.0, scope="pack"):
                flat, offsets, src_lens = pack_signals(
                    [s for _, s, _ in batch], b_pad, self.mesh, pcm16_exact=exact,
                )
            if src_rate == self.cfg.sample_rate:
                lengths = src_lengths
                bucket = bucket_length(int(lengths.max()))
                bucket = ((bucket + align - 1) // align) * align
                msg = {"kind": "batch", "offsets": offsets, "lengths": src_lens,
                       "t": bucket}
            else:
                g = math.gcd(self.cfg.sample_rate, src_rate)
                up, down = self.cfg.sample_rate // g, src_rate // g
                lengths = -(-src_lengths * up // down)
                # source bucket: multiple of `down` (integer output length)
                # and of down*align/gcd(align, up) (aligned output bucket);
                # zero padding is transparent through the linear resampler
                step = down * align // math.gcd(align, up)
                m0 = bucket_length(int(src_lengths.max()))
                src_bucket = ((m0 + step - 1) // step) * step
                lens = np.zeros(b_pad, dtype=np.int64)
                lens[:b] = lengths
                msg = {"kind": "resample", "offsets": offsets, "src_lengths": src_lens,
                       "src_t": src_bucket, "up": up, "down": down, "lengths": lens}
                self.meter.bump("dispatches")  # the unpack + resample pass
            counts = None
            if self.packed_output:
                counts = np.zeros(b_pad, dtype=np.int64)
                counts[:b] = frame_counts_host(lengths, self.cfg, self.feature)
            msg["counts"] = counts
            # bytes rank 0 copies host->device: the flat samples and its
            # rows of the int64 arrays (offsets and lengths, the resample's
            # target lengths, and the frame counts and offsets of packed
            # outputs); the other ranks receive the samples by broadcast
            n_int = (2 if msg["kind"] == "batch" else 3) + (2 if counts is not None else 0)
            self.meter.bump("h2d_bytes", flat.nbytes + n_int * 8 * (b_pad // n_data))
            audio_sec = float(lengths.sum()) / self.cfg.sample_rate
            self.meter.bump("dispatches")
            with self.meter.measure(0.0, scope="dispatch"), self.meter.span("dispatch"):
                out = send_and_step(msg, flat)
            inflight.append((ids, out, audio_sec, counts))
            if len(inflight) >= self.fetch_every:
                drain()

        def drain():
            # gather the in-flight group onto this rank (a collective, in
            # dispatch order on every rank) and submit it for fetching (ONE
            # packed copy per group); with fetch threads, the copy overlaps
            # further dispatch/decode and older groups are consumed once the
            # bounded queue fills — always in dispatch order
            if not inflight:
                return
            from .data import fetch_outputs

            records = list(inflight)
            inflight.clear()
            trees = [gather_outputs(r[1], self.mesh) for r in records]
            self.meter.bump("fetch_groups")
            self.meter.bump("d2h_bytes", tree_bytes(trees))
            if executor is None:
                group_audio = sum(r[2] for r in records)
                with self.meter.measure(group_audio, scope="fetch"), self.meter.span("fetch"):
                    fetched = fetch_outputs(trees)
                consume(records, fetched)
                return
            # the pool copies only work enqueued before this point: the
            # event marks it, and the fetch thread waits on it first
            ready = torch.cuda.Event() if dev.type == "cuda" else None
            if ready is not None:
                ready.record(torch.cuda.current_stream(dev))

            def timed_fetch(trees=trees, ready=ready):
                with self.meter.span("fetch"):
                    if ready is not None:
                        ready.synchronize()
                    return fetch_outputs(trees)

            pending_fetches.append((records, executor.submit(timed_fetch)))
            while len(pending_fetches) > max_pending:
                consume_oldest()

        def consume_oldest():
            records, fut = pending_fetches.popleft()
            group_audio = sum(r[2] for r in records)
            # only the residual wait bills here: the copy itself ran
            # concurrently in the fetch pool
            with self.meter.measure(group_audio, scope="fetch"):
                fetched = fut.result()
            consume(records, fetched)

        def consume(records, fetched):
            nonlocal moments, batches_since_ckpt
            for (ids, _, audio_sec, counts), out in zip(records, fetched):
                if counts is not None:
                    feats, batch_moments = out
                    row_off = np.zeros(len(ids) + 1, dtype=np.int64)
                    np.cumsum(counts[: len(ids)], out=row_off[1:])
                else:
                    feats, mask, batch_moments = out
                if self.multi:
                    feats = {k: (v[0] if k == "mfe" else v) for k, v in feats.items()}
                    moments = {k: moments[k].merge(batch_moments[k]) for k in moments}
                else:
                    moments = moments.merge(batch_moments)
                if self.out_dir:
                    for r, utt_id in enumerate(ids):
                        out_path = self.out_dir / self._out_names[utt_id]
                        if counts is not None:
                            lo, hi = int(row_off[r]), int(row_off[r + 1])
                            if self.multi:
                                payload = {k: v[lo:hi] for k, v in feats.items()}
                            else:
                                payload = feats[lo:hi]
                        elif self.multi:
                            n_valid = int(mask[r].sum())
                            payload = {k: v[r, :n_valid] for k, v in feats.items()}
                        else:
                            payload = feats[r, : int(mask[r].sum())]
                        if writer is not None:
                            write_futures.append(writer.submit(write_one, out_path, payload))
                        else:
                            with self.meter.measure(0.0, scope="write"):
                                write_one(out_path, payload)
                if self.store is not None:
                    self.store.mark(ids, batch_moments)
                    batches_since_ckpt += 1
                    if batches_since_ckpt >= self.checkpoint_every:
                        flush_writes()
                        self.store.save()
                        batches_since_ckpt = 0
                if self.on_batch:
                    self.on_batch({"utts": len(ids), "audio_seconds": audio_sec,
                                   "throughput": self.meter.throughput})

        import math

        try:
            # the "run" span brackets the whole consume loop
            self.meter.spans.append(("run", time.perf_counter(), 0.0))
            it = iter(loader)
            while True:
                with self.meter.measure(0.0, scope="decode_wait"):
                    rec = next(it, None)
                if rec is None:
                    break
                j, samples, sr, meta = rec
                if sr != self.cfg.sample_rate and not self.resample:
                    raise ValueError(
                        f"{self.all_paths[todo[j]]}: sample rate {sr} != "
                        f"config {self.cfg.sample_rate} (pass resample=True to convert)"
                    )
                # frame-count check at the TARGET rate (post-resample length)
                if sr == self.cfg.sample_rate:
                    n_t = len(samples)
                else:
                    g = math.gcd(self.cfg.sample_rate, sr)
                    n_t = -(-len(samples) * (self.cfg.sample_rate // g) // (sr // g))
                # drop utterances too short to produce one frame (the
                # reference yields an empty matrix for these); the
                # vorbis/melspec path frames any length (ceil(L/hop) chunks)
                if self.feature == "melspec":
                    num = -(-n_t // hop)
                else:
                    num, _ = speechpy_frame_counts(n_t, self.cfg.frame_size, hop,
                                                   zero_padding=False)
                if num <= 0:
                    if self.store is not None:
                        self.store.done[todo[j]] = True
                    continue
                # pools key on (rate, length bucket); coarser bands with
                # pool_growth — see __init__
                key = (sr, bucket_length(len(samples)) if self.pool_growth is None
                       else bucket_length(len(samples), growth=self.pool_growth))
                pool = pending.setdefault(key, [])
                pool.append((j, samples, meta))
                if len(pool) >= self.batch_size:
                    dispatch(pool, sr)
                    pending[key] = []
            for (sr, _), pool in pending.items():
                if pool:
                    dispatch(pool, sr)
            if multi_rank:
                self._send({"kind": "stop"})
                self._stopped = True
            drain()
            while pending_fetches:
                consume_oldest()
            flush_writes()
        finally:
            for i, (n, t0, t1) in enumerate(self.meter.spans):
                if n == "run" and t1 == 0.0:
                    self.meter.spans[i] = ("run", t0, time.perf_counter())
            if executor is not None:
                executor.shutdown(wait=True)
            if writer is not None:
                writer.shutdown(wait=True)
        if self.store is not None:
            self.store.moments = moments
            self.store.save()
        return moments
