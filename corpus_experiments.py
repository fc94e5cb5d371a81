#!/usr/bin/env python3
"""Corpus-runner experiments on one CUDA card.

    python3 corpus_experiments.py [--clips N] [--out DIR]

Writes N WAV files with ``chip_smoke.py``'s corpus profile (seed 0:
durations clip(lognormal(ln 6 s, 0.6), 1, 35) at 16 kHz, N(0, 0.1)) and
runs ``CorpusRunner`` over them (``"mfcc"``, batch 32, one-rank CUDA mesh,
the runner's defaults) for each variant, in turns (forward, then
backward), twice:

* ``shipped``: host->device copies staged through pinned memory,
  asynchronous (``parallel.data._upload``);
* ``pageable``: the same copies straight from pageable memory (each waits
  for the work already queued on the stream);
* ``fetch_every=4``: four batches to a device->host copy;
* ``io_threads=8``: eight decode threads in place of four.

Each run prints its wall seconds, audio-s/s and host scopes.  Then one
run of the shipped runner under ``torch.profiler`` (CUDA activity): the
device time of its kernels and copies against the run's wall gives the
card's busy share (the profiler's own cost lengthens that wall).  With
``--out DIR`` every run's record goes to ``DIR/corpus_experiments.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=1024)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("corpus_experiments: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import mfcc_rust_tpu_torch as P
    from mfcc_rust_tpu_torch.parallel import data, make_mesh, runner
    from mfcc_rust_tpu_torch.runtime import native_available, write_wav

    assert native_available(), "the native WAV runtime did not build"
    card = cs.smi("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    shipped_upload = data._upload

    def pageable(a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def set_upload(fn):
        data._upload = runner._upload = fn

    variants = {
        "shipped": ({}, shipped_upload),
        "pageable": ({}, pageable),
        "fetch_every=4": ({"fetch_every": 4}, shipped_upload),
        "io_threads=8": ({"n_io_threads": 8}, shipped_upload),
    }
    rec = {"card": card, "clips": args.clips, "runs": {k: [] for k in variants}}
    cfg = P.FeatureConfig(sample_rate=16000)
    mesh = make_mesh()
    with tempfile.TemporaryDirectory(prefix="corpus_exp_") as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(0)
        lengths = cs.corpus_lengths(np, rng, args.clips, 16000)
        paths = cs.write_corpus(np, write_wav, rng, lengths, [16000] * args.clips, tmp / "wav")
        audio_s = sum(lengths) / 16000
        rec["audio_s"] = audio_s
        print(f"{args.clips} clips, {audio_s:.1f} audio-s", flush=True)

        def run(name, n):
            kw, upload = variants[name]
            set_upload(upload)
            out = tmp / f"out{n}"
            r = runner.CorpusRunner(paths, cfg, mesh, batch_size=32, out_dir=str(out), **kw)
            t0 = time.perf_counter()
            r.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            set_upload(shipped_upload)
            for f in out.iterdir():
                f.unlink()
            out.rmdir()
            return wall, dict(r.meter.scopes)

        run("shipped", -1)  # warm: constants, the first launches
        n = 0
        order = list(variants)
        for turn in range(2):
            for name in order if turn % 2 == 0 else order[::-1]:
                wall, scopes = run(name, n)
                n += 1
                rec["runs"][name].append({"wall_s": wall, "scopes": scopes})
                print(f"{name}: {wall:.4f} s, {audio_s / wall:.1f} audio-s/s; "
                      + ", ".join(f"{k} {v:.4f}" for k, v in sorted(scopes.items())),
                      flush=True)
        for name, runs in rec["runs"].items():
            w = statistics.median(r["wall_s"] for r in runs)
            print(f"median {name}: {w:.4f} s, {audio_s / w:.1f} audio-s/s", flush=True)

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, scopes = run("shipped", n)
        # the device's own events (kernels, copies); a CPU op's device time
        # repeats its kernels'
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        events.sort(key=lambda e: -e.self_device_time_total)
        device_us = sum(e.self_device_time_total for e in events)
        rec["profiled"] = {"wall_s": wall, "device_s": device_us / 1e6, "scopes": scopes,
                           "top": [(e.key, e.self_device_time_total, e.count)
                                   for e in events[:12]]}
        if device_us > 0:
            print(f"profiled shipped run: {wall:.4f} s of wall, {device_us / 1e6:.4f} s of device "
                  f"time (busy share {device_us / 1e6 / wall:.4f})", flush=True)
            for key, us, count in rec["profiled"]["top"]:
                print(f"  {us / 1e3:.3f} ms  x{count}  {key[:90]}", flush=True)
        else:
            print("profiled shipped run: the profile shows no device time (not measured)")
    rec["clocks"] = cs.smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    print(f"clocks.sm, power.draw, power.limit, temperature: {rec['clocks']}", flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "corpus_experiments.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
