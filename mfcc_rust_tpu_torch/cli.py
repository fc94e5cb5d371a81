"""Command-line corpus extraction: ``python -m mfcc_rust_tpu_torch <wavs...>``
(port of ``mfcc_rust_tpu.cli``).

Wraps :class:`.parallel.runner.CorpusRunner` with the reference CLI's
arguments, plus ``--device`` (default ``cuda``; ``--device cpu`` runs on
the CPU), a multi-host bootstrap on ``torch.distributed`` and a final
metrics line.

Multi-host: one process a card.  Under ``torchrun`` (``WORLD_SIZE`` in the
environment) the processes join with ``env://``; with ``--coordinator
HOST:PORT --num-hosts N --host-id I`` one process a host joins over TCP.
Every process then makes one group per host (``LOCAL_WORLD_SIZE``
processes each, in host order on every process) and extracts on a mesh over
its host's group; each host's runner takes its slice of the file list
(``process_index`` = the host, ``process_count`` = the hosts), and the
mesh's rank 0 of each host prints the report and writes ``--cmvn-out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mfcc_rust_tpu_torch",
        description="Speech feature extraction over a WAV corpus on CUDA cards",
    )
    p.add_argument("inputs", nargs="+",
                   help="WAV files or globs (e.g. 'corpus/**/*.wav')")
    p.add_argument("--feature", default="mfcc",
                   help="one of mfcc/lmfe/mfe/ssc/energy/melspec, or a "
                        "comma-separated list (e.g. 'mfcc,lmfe,ssc') for a "
                        "single-frontend-pass multi-feature run writing .npz "
                        "bundles (melspec cannot join a list)")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--fft-points", type=int, default=512)
    p.add_argument("--frame-length", type=float, default=0.020)
    p.add_argument("--frame-stride", type=float, default=0.010)
    p.add_argument("--num-cepstral", type=int, default=13)
    p.add_argument("--num-filters", type=int, default=40)
    p.add_argument("--low-frequency", type=float, default=0.0)
    p.add_argument("--high-frequency", type=float, default=None)
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="kept from the reference; the port computes in IEEE "
                        "FP32 whatever it says")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--out-dir", required=True,
                   help="directory for per-utterance .npy features")
    p.add_argument("--checkpoint", default=None,
                   help="npz checkpoint path for resumable runs")
    p.add_argument("--seq-shards", type=int, default=1,
                   help="sequence-parallel shards (long-audio halo mode)")
    p.add_argument("--resample", action="store_true",
                   help="polyphase-resample inputs whose rate differs from "
                        "--sample-rate (default: error on mismatch)")
    p.add_argument("--io-threads", type=int, default=4)
    p.add_argument("--fetch-every", type=int, default=1,
                   help="dispatch-ahead depth: batches kept in flight on the"
                        " device before one grouped device->host fetch")
    p.add_argument("--fetch-threads", type=int, default=2,
                   help="concurrent device->host fetches (0 = synchronous);"
                        " results are consumed in dispatch order regardless")
    p.add_argument("--pool-growth", type=float, default=None,
                   help="coarse geometric band grid for batch pooling "
                        "(e.g. 2.5): fewer, larger batches; default pools on "
                        "the fine bucket grid")
    p.add_argument("--wire-dtype", default=None,
                   choices=["float16", "bfloat16"],
                   help="16-bit device->host feature wire (halves D2H "
                        "bytes; lossy: ~2^-11 relative quantization, "
                        "outputs written in the wire dtype)")
    p.add_argument("--max-seconds", type=float, default=240.0,
                   help="decode cap per utterance (longer files are truncated"
                        " with a warning)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address (host:port)")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    p.add_argument("--cmvn-out", default=None,
                   help="write corpus CMVN moments (npz) here")
    p.add_argument("--device", default="cuda",
                   help="device of this process's rank: cuda (the card of "
                        "LOCAL_RANK) or cpu")
    p.add_argument("--quiet", action="store_true")
    return p


def _join(args, device: str):
    """Join the process group when the command line or the environment asks
    for one; returns (process_index, process_count, this host's group or
    None).  The hosts' groups are made on every process in host order, as
    ``new_group`` asks."""
    import torch.distributed as dist

    from .parallel.mesh import init_process_group, initialize_multihost

    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        init_process_group("env://", device=device)
    else:
        initialize_multihost(args.coordinator, args.num_hosts, args.host_id, device=device)
    if not dist.is_initialized():
        return 0, 1, None
    rank, world = dist.get_rank(), dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if world % local:
        raise ValueError(f"world size {world} is not a multiple of LOCAL_WORLD_SIZE {local}")
    mine = None
    for h in range(world // local):
        g = dist.new_group(list(range(h * local, (h + 1) * local)))
        if h == rank // local:
            mine = g
    return rank // local, world // local, mine


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .config import FeatureConfig, vorbis_config
    from .parallel.mesh import make_mesh
    from .parallel.runner import CorpusRunner

    paths: List[str] = []
    for pattern in args.inputs:
        hits = sorted(glob.glob(pattern, recursive=True))
        if hits:
            paths.extend(hits)
        elif os.path.exists(pattern):
            paths.append(pattern)
        else:
            print(f"warning: no files match {pattern!r}", file=sys.stderr)
    if not paths:
        print("no input files", file=sys.stderr)
        return 2

    kw = dict(
        sample_rate=args.sample_rate,
        fft_points=args.fft_points,
        frame_length=args.frame_length,
        frame_stride=args.frame_stride,
        num_cepstral=args.num_cepstral,
        num_filters=args.num_filters,
        low_frequency=args.low_frequency,
        high_frequency=args.high_frequency,
        precision=args.precision,
    )
    single = {"mfcc", "lmfe", "mfe", "ssc", "melspec"}
    feature = args.feature
    if "," in feature:
        feature = tuple(f.strip() for f in feature.split(",") if f.strip())
        bad = set(feature) - (single - {"melspec"} | {"energy"})
        if bad:
            print(f"invalid multi-feature entries: {sorted(bad)}", file=sys.stderr)
            return 2
    elif feature not in single:
        print(f"invalid --feature {feature!r}", file=sys.stderr)
        return 2
    cfg = vorbis_config(**kw) if feature == "melspec" else FeatureConfig(**kw)

    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    process_index, process_count, host_group = _join(args, device.type)
    try:
        mesh = make_mesh(n_seq=args.seq_shards, group=host_group, device=device)
        runner = CorpusRunner(
            paths,
            cfg,
            mesh,
            feature=feature,
            batch_size=args.batch_size,
            out_dir=args.out_dir,
            checkpoint_path=args.checkpoint,
            process_index=process_index,
            process_count=process_count,
            n_io_threads=args.io_threads,
            max_seconds=args.max_seconds,
            resample=args.resample,
            fetch_every=args.fetch_every,
            fetch_threads=args.fetch_threads,
            wire_dtype=args.wire_dtype,
            pool_growth=args.pool_growth,
            on_batch=None if args.quiet else (
                lambda info: print(json.dumps({"batch": info}), file=sys.stderr)
            ),
        )
        moments = runner.run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if not mesh.is_root:
        return 0

    if args.cmvn_out:
        items = moments.items() if isinstance(moments, dict) else [("", moments)]
        arrays = {}
        for name, mom in items:
            sfx = f"_{name}" if name else ""
            arrays["count" + sfx] = np.asarray(mom.count)
            arrays["mean" + sfx] = np.asarray(mom.mean)
            arrays["m2" + sfx] = np.asarray(mom.m2)
            arrays["std" + sfx] = np.asarray(mom.std)
        np.savez(args.cmvn_out, **arrays)
    report = runner.meter.report()
    report["utterances"] = int(len(runner.indices))
    first = next(iter(moments.values())) if isinstance(moments, dict) else moments
    report["corpus_frames"] = int(first.count)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
