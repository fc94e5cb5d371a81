"""The port's two whole-surface checks: the flagship forward step on one
card, and a dry run of the sharded extraction surface on n ranks.

* :func:`entry` returns ``(fn, example_args)``: ``fn`` is the speechpy
  MFCC-13 at 16 kHz (:func:`.features.mfcc` with
  ``FeatureConfig(sample_rate=16000)``) and the example is an (8, 16000)
  float32 batch.  On a CUDA float32 batch ``fn`` is one launch of the fused
  MFCC kernel.
* :func:`dryrun_multichip` runs one step of each sharded path on a (data,
  seq) mesh of ``n_devices`` ranks and checks its shapes and moments: the
  padded step, the packed int16 step, four heads in one pass, packed
  outputs, the hop-misaligned 25/10 step, the vorbis mel on the seq axis,
  then a ``CorpusRunner`` round trip and its resume.  One rank is one
  process (SPMD on ``torch.distributed``): at one rank the body runs in the
  calling process, past one it runs in ``n_devices`` spawned processes of
  one NCCL group on that many cards, or of one gloo group when the caller
  passes ``device="cpu"``.

Both default to CUDA and raise without it; the CPU runs only when asked.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import FeatureConfig, vorbis_config
from .utils.device import resolve_device


def entry(device=None):
    """(fn, example_args): the flagship forward step, batched MFCC-13 at
    16 kHz, and a zero (8, 16000) float32 batch on ``device`` (default
    CUDA)."""
    from . import features

    dev = resolve_device(device)
    cfg = FeatureConfig(sample_rate=16000)

    def fn(signals):
        return features.mfcc(signals, cfg)

    example_args = (torch.zeros((8, 16000), dtype=torch.float32, device=dev),)
    return fn, example_args


def _dryrun(n_devices: int, device: torch.device, work: str) -> dict:
    """The dry run's body on one rank of an ``n_devices`` mesh; every rank
    runs it with the same seeded inputs.  Each rank checks its own blocks
    and moments, the mesh's rank 0 the gathered global arrays.  Returns
    what the run did (rank 0's view)."""
    from .parallel import (extraction_step, extraction_step_packed, frame_counts_host,
                           make_mesh, pack_signals)
    from .parallel.data import gather_outputs
    from .parallel.runner import CorpusRunner
    from .runtime import write_wav

    n_seq = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    n_data = n_devices // n_seq
    mesh = make_mesh(n_data, n_seq, device=device)
    cfg = FeatureConfig(sample_rate=16000)
    hop = cfg.frame_step

    b = 2 * n_data
    t = hop * 8 * n_seq  # multiple of seq*hop, > frame_size
    bl, fl = b // n_data, t // hop // n_seq  # this rank's block
    rng = np.random.default_rng(0)
    signals = rng.normal(0, 0.1, (b, t)).astype(np.float32)
    lengths = np.full((b,), t, dtype=np.int32)

    # 1) plain padded batch, single feature
    feats, mask, moments = extraction_step(signals, lengths, cfg, mesh)
    assert feats.shape == (bl, fl, cfg.num_cepstral), tuple(feats.shape)
    assert bool(moments.count > 0)
    g = gather_outputs((feats, mask, moments), mesh)
    assert g is None or g[0].shape == (b, t // hop, cfg.num_cepstral), tuple(g[0].shape)

    # 2) packed int16 transfer: ragged clips, device-side unpack
    clips = [
        (rng.integers(-2000, 2000, rng.integers(cfg.frame_size, t + 1))
         .astype(np.float32) / np.float32(32768.0))
        for _ in range(b)
    ]
    flat, offsets, lens = pack_signals(clips, b, mesh, pcm16_exact=True)
    pf, pmask, pmom = extraction_step_packed(flat, offsets, lens, t, cfg, mesh, "mfcc")
    assert pf.shape == (bl, fl, cfg.num_cepstral), tuple(pf.shape)
    assert bool(pmom.count > 0)
    g = gather_outputs((pf, pmask, pmom), mesh)
    assert g is None or g[0].shape == (b, t // hop, cfg.num_cepstral), tuple(g[0].shape)

    # 3) four heads through the packed path (one shared frontend)
    which = ("mfcc", "lmfe", "ssc", "energy")
    mf, mmask, mmom = extraction_step_packed(flat, offsets, lens, t, cfg, mesh, which)
    assert set(mf) == set(which)
    assert mf["lmfe"].shape == (bl, fl, cfg.num_filters), tuple(mf["lmfe"].shape)
    assert all(bool(mmom[k].count > 0) for k in which)
    g = gather_outputs((mf, mmask, mmom), mesh)
    assert g is None or g[0]["lmfe"].shape == (b, t // hop, cfg.num_filters)

    # 3b) packed outputs: dense buffers of the valid frames
    counts = frame_counts_host(lens, cfg, "mfcc")
    pko, pkmom = extraction_step_packed(flat, offsets, lens, t, cfg, mesh, "mfcc",
                                        frame_counts=counts)
    assert pko.ndim == 2 and pko.shape[1] == cfg.num_cepstral, tuple(pko.shape)
    assert bool(pkmom.count > 0)
    g = gather_outputs((pko, pkmom), mesh)
    assert g is None or g[0].shape == (int(counts.sum()), cfg.num_cepstral), tuple(g[0].shape)

    # 3c) hop-misaligned frames: 25 ms / 10 ms, 400/160
    mcfg = cfg.replace(frame_length=0.025)
    mf2, mmask2, mmom2 = extraction_step(signals, lengths, mcfg, mesh)
    assert mf2.shape == (bl, fl, cfg.num_cepstral), tuple(mf2.shape)
    assert bool(mmom2.count > 0)
    g = gather_outputs((mf2, mmask2, mmom2), mesh)
    assert g is None or g[0].shape == (b, t // hop, cfg.num_cepstral), tuple(g[0].shape)

    # 4) vorbis mel spectrogram on the seq axis (left-halo frames)
    vcfg = vorbis_config(16000)
    vhop = vcfg.stream_hop
    tv = vhop * 4 * max(n_seq, 1)
    vsig = rng.normal(0, 0.1, (b, tv)).astype(np.float32)
    vlens = np.full((b,), tv, dtype=np.int32)
    vf, vmask, vmom = extraction_step(vsig, vlens, vcfg, mesh, "melspec")
    assert vf.shape == (bl, tv // vhop // n_seq, vcfg.num_filters), tuple(vf.shape)
    assert bool(vmom.count > 0)
    g = gather_outputs((vf, vmask, vmom), mesh)
    assert g is None or g[0].shape == (b, tv // vhop, vcfg.num_filters), tuple(g[0].shape)

    # 5) the corpus runner on the same mesh: WAV files -> packed transfers ->
    # float16 wire -> .npy writes -> checkpoint, then a resume that must
    # find nothing left to do
    tmp = Path(work) / "corpus"
    paths = []
    for i in range(2 * b):
        clip = (rng.integers(-2000, 2000, int(t * (0.5 + 0.5 * (i % 3))))
                .astype(np.float32) / np.float32(32768.0))
        p = str(tmp / f"utt{i:03d}.wav")
        if mesh.is_root:
            tmp.mkdir(exist_ok=True)
            write_wav(p, clip, 16000)
        paths.append(p)
    if mesh.group is not None:  # the files exist before any rank reads them
        dist.barrier(group=mesh.group)
    runner = CorpusRunner(
        paths, cfg, mesh, batch_size=b, out_dir=str(tmp / "out"),
        checkpoint_path=str(tmp / "ckpt.npz"), checkpoint_every=1, wire_dtype="float16",
    )
    mom = runner.run()
    assert float(mom.count) > 0
    if mesh.is_root:
        outs = sorted(os.listdir(tmp / "out"))
        assert len(outs) == len(paths), (len(outs), len(paths))
    r2 = CorpusRunner(
        paths, cfg, mesh, batch_size=b, out_dir=str(tmp / "out"),
        checkpoint_path=str(tmp / "ckpt.npz"), wire_dtype="float16",
    )
    mom2 = r2.run()
    assert float(mom2.count) == float(mom.count)
    assert r2.meter.batches == 0  # nothing left to do
    return {"mesh": [n_data, n_seq], "batch": b, "time": t,
            "runner_dispatches": int(runner.meter.counters.get("dispatches", 0)),
            "corpus_frames": float(mom.count)}


def _rank(rank: int, world: int, device_type: str, init: str, threads: int, body,
          args) -> None:
    """One spawned rank: join the group of ``world`` ranks at ``init``,
    run ``body(world, device, *args)``, write rank 0's result next to the
    rendezvous file."""
    from .parallel.mesh import init_process_group

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(threads)
        dev = torch.device("cpu")
    init_process_group(init, world_size=world, rank=rank, device=dev)
    result = body(world, dev, *args)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        Path(init[len("file://"):] + ".json").write_text(json.dumps(result))


def _spawn(n: int, device: torch.device, body, args=(), timeout: float = 900.0):
    """Run ``body(n, device, *args)`` on ``n`` spawned ranks of one group
    (NCCL on ``n`` cards, gloo on the CPU) and return rank 0's result.  A
    rank that raises makes this raise (the other ranks are stopped), and so
    do ranks still running after ``timeout`` seconds (they are killed)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mfcc_ranks_") as rdv:
        init = f"file://{rdv}/pg"
        threads = max(1, torch.get_num_threads() // n)
        ctx = mp.start_processes(_rank, args=(n, device.type, init, threads, body, args),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{n} ranks still running after {timeout} s")
        return json.loads(Path(f"{rdv}/pg.json").read_text())


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of every sharded path on a mesh of ``n_devices`` ranks
    (``n_seq = 2`` when ``n_devices`` is even and at least 4), each output
    checked; see the module's docstring.  ``device`` defaults to CUDA:
    ``n_devices`` cards are then required, and fewer raise.  With
    ``device="cpu"`` the ranks form a gloo group.  Returns rank 0's
    summary: the mesh, the step's batch and length, the runner's dispatched
    batches and its corpus frame count."""
    from .runtime.build import load_native

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"need {n_devices} CUDA devices, have {torch.cuda.device_count()}"
        )
    load_native()  # build the WAV runtime once, before any rank needs it
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        if n_devices == 1:
            return _dryrun(1, dev, work)
        return _spawn(n_devices, dev, _dryrun, (work,))
