#!/usr/bin/env python3
"""Times variants of kernel K1 (``speechpy_mfcc.cu``) against the shipped
build on one CUDA card, at the speechpy headline: B = 48 x 177,664 samples,
fft 512, 20 ms frames every 10 ms, 40 mels, 13 cepstra.

    python3 k1_experiments.py [--out DIR]

Each variant is a copy of the same source with one line rewritten, compiled
into a temporary directory with the build's own flags: experiments, not
options of the kernel.

* ``path 2``: the path choice returns 2, so n = 512 takes the shared-memory
  Stockham stages of ``fft_stages.cuh`` in place of the register FFT;
* ``float32 DC``: X_0 and X_{n/2} summed in float32, not float64;
* ``fast log``: ``__logf`` in place of ``logf``;
* ``16 lanes a frame``: path 1 gives a frame 16 lanes of 16 points below
  n = 1024 (two frames a warp at n = 512), in place of 32 lanes of 8;
* ablations (wrong answers, timed only): ``no FFT`` skips the FFT passes,
  ``no epilogue`` the split, mel, log and DCT, ``neither`` both.

The shipped build, ``path 2``, ``float32 DC`` and ``fast log`` are held to
the plain version (max|Δ|/max|ref| printed; <= 1e-4 asserted for the first
two).  Times are CUDA events after an L2 flush, in turns (the variants in
order, then in reverse), 25 samples a turn.  Prints the card's name and
power limit, then one JSON line.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PATH1 = "return (n % 2 == 0 && nc >= 64 && nc <= 512 && (nc & (nc - 1)) == 0) ? 1 : 2;"
FFT = "    fft_regs<NC>(a, re, im, A.tw, lt);"
TAIL = "    frame_tail([re, im](int i)"
EDITS = {
    "path 2": [(PATH1, "return 2;")],
    "float32 DC": [("double d0 = 0.0, dn = 0.0;", "float d0 = 0.f, dn = 0.f;"),
                   ("d0 += (double)x0 + (double)x1;", "d0 += x0 + x1;"),
                   ("dn += (double)x0 - (double)x1;", "dn += x0 - x1;")],
    "fast log": [("logf(", "__logf(")],
    "16 lanes a frame": [("return nc >= 256 ? 32 : nc / 8;", "return nc >= 512 ? 32 : nc / 16;")],
    "no FFT": [(FFT, "    if (A.n < 0) fft_regs<NC>(a, re, im, A.tw, lt);")],
    "no epilogue": [(TAIL, "    if (A.n < 0) frame_tail([re, im](int i)")],
}
EDITS["neither"] = EDITS["no FFT"] + EDITS["no epilogue"]
CHECKED = ("shipped", "path 2", "float32 DC", "fast log", "16 lanes a frame")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, help="directory for k1_experiments.json")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_experiments: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mfcc_rust_tpu_torch as P
    from chip_smoke import cuda_ms, rel_err, smi
    from mfcc_rust_tpu_torch.ops.cuda import build
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length

    cfg = P.speechpy_config(16000)
    t = bucket_length(160000)
    x = torch.from_numpy(np.random.default_rng(0).normal(0.0, 0.1, (48, t)).astype(np.float32))
    x = x.cuda()
    frames = (t - cfg.frame_size) // cfg.frame_step
    src = (build.HERE / "speechpy_mfcc.cu").read_text()
    libs = {"shipped": k1._lib()}
    record = {"card": smi("name,power.limit"), "shape": [48, t], "rel": {}, "ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in EDITS.items():
            text = src
            for old, new in edits:
                assert old in text, (name, old)
                text = text.replace(old, new)
            d = Path(tmp) / str(len(libs))
            d.mkdir()
            (d / "speechpy_mfcc.cu").write_text(text)
            (d / "fft_stages.cuh").write_text((build.HERE / "fft_stages.cuh").read_text())
            res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                                  str(d / "speechpy_mfcc.cu")], capture_output=True, text=True)
            assert res.returncode == 0, (name, res.stdout, res.stderr)
            record["ptxas"][name] = [ln.strip() for ln in res.stdout.splitlines()
                                     if "registers" in ln or "spill" in ln]
            libs[name] = k1._bind(ctypes.CDLL(str(d / "lib.so")))

        ref = k1.mfcc_fused_plain(x, cfg)
        outs = {k: torch.empty((48, frames, cfg.num_cepstral), device=x.device) for k in libs}
        runs = {k: (lambda k=k: k1._launch(libs[k], x, cfg, outs[k])) for k in libs}
        for k in CHECKED:
            runs[k]()
            torch.cuda.synchronize()
            record["rel"][k] = rel_err(outs[k], ref)[0]
        assert record["rel"]["shipped"] <= 1e-4 and record["rel"]["path 2"] <= 1e-4, record["rel"]
        flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=x.device)
        times = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            times[k] += cuda_ms(torch, runs[k], 25, flush_buf.zero_)
    record["times_ms"] = times
    record["median_ms"] = {k: statistics.median(v) for k, v in times.items()}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "k1_experiments.json").write_text(json.dumps(record, indent=1))
    print(record["card"])
    print(json.dumps({k: record[k] for k in ("card", "shape", "rel", "median_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
