#!/usr/bin/env python3
"""Times variants of the port's kernels against the shipped builds on one
CUDA card.

    python3 k1_experiments.py [--out DIR]

Each variant is a copy of the kernel's source and the shared ``*.cuh``
headers with a few lines rewritten, compiled into a temporary directory with
the build's own flags: experiments, not options of the kernels.

K1 (``speechpy_mfcc.cu``) at the speechpy headline, B = 48 x 177,664
samples, fft 512, 20 ms frames every 10 ms, 40 mels, 13 cepstra:

* ``path 2``: the path choice returns 2, so n = 512 takes the shared-memory
  Stockham stages of ``fft_stages.cuh`` in place of the register FFT;
* ``float32 DC``: X_0 and X_{n/2} summed in float32, not float64;
* ``fast log``: ``__logf`` in place of ``logf``;
* ``16 lanes a frame``: path 1 gives a frame 16 lanes of 16 points below
  n = 1024 (two frames a warp at n = 512), in place of 32 lanes of 8;
* ablations (wrong answers, timed only): ``no FFT`` skips the FFT passes,
  ``no epilogue`` the split, mel, log and DCT, ``neither`` both.

K2 (``ct_mel.cu``) at the librosa headline, B = 32 x 277,632 samples, n_fft
2048, hop 512, 128 mels (path 1, nc = 1024):

* ``path 2``: the path choice returns 2 (v4's Stockham stages, G frames a
  block), at n_fft 400 too (not path 3);
* ``shared split``: the last radix-32 pass writes Z to the exchange
  buffers and the real split reads Z[k] and Z[nc - k] from there (as
  below nc = 1024), in place of keeping Z in registers and taking the
  partner by shuffle; the power spectrum gets its own buffer;
* ``window by __ldg``: the window read through the read-only cache, not
  from shared memory;
* ``8-frame tiles``: kTileF 8 in place of 16;
* ablations (wrong answers, timed only): ``no FFT`` skips the passes,
  ``no epilogue`` the split, power and mel (the registers are summed into
  one store so the passes stay live), ``neither`` both.

Then K2's path rule: the shipped build against ``path 2`` at n_fft 128,
256, 512, 1024 and 2048 (librosa configs at 8, 16 and 22.05 kHz, 10 s
clips), and at Whisper's 400/160/128 on the Whisper cell's 64 rows of 30 s
(path 3 against path 2).

Every variant that computes the function is held to the plain version
(max|Δ|/max|ref| printed; <= 1e-4 asserted for the shipped builds and the
path-2 copies), and the launch plans of the shipped and path-2 builds are
asserted to take the path each name claims.  Times are CUDA events after an L2 flush, in turns (the
variants in order, then in reverse), 25 samples a turn.  Prints the card's
name and power limit, then one JSON line.  Without a CUDA device it exits 1.
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

K2_PATH1 = "  if (!path1_size(n)) return 0;"  # path1_warps: no warps, so path 2
K2_PATH3 = "  if (!path3_size(n)) return 0;"  # path3_warps: the same at n = 400
K2_FFT = "      fft_regs<NC>(a, re, im, A.tw, lt, w1, w8);"
K2_SPLIT = ("      // real split of bins k = lt + 32 j: Z[k] = a[j], Z[nc - k] by shuffle\n"
            "#pragma unroll\n      for (int j = 0; j < 32; ++j) {")
K2_SPLIT_END = "      }\n      if (lt == 0 && A.kmax > NC) {"
K2_MEL = "    if (f < A.F) {"
K2_EDITS = {
    "path 2": [(K2_PATH1, "  return 0;"), (K2_PATH3, "  return 0;")],
    "shared split": [
        ("    frame = nc == 1024 ? 2 * round4(xpad<1024>(nc)) : 2 * round4(pad8(nc)) + round4(kmax);",
         "    frame = 2 * round4(nc == 1024 ? xpad<1024>(nc) : pad8(nc)) + round4(kmax);"),
        ("  float* pw = NC == 1024 ? re : im + Q::BUF;", "  float* pw = im + Q::BUF;"),
        ("    if constexpr (NC == 1024) {\n" + K2_FFT,
         "    if constexpr (NC == 1024 && NC < 0) {\n" + K2_FFT),
        ("      fft_regs<NC>(a, re, im, A.tw, lt);\n      for (int k = lt;",
         "      if constexpr (NC == 1024) {\n"
         "        pass<NC, 32, 1>(a, re, im, A.tw, lt);\n        __syncwarp();\n"
         "        gather<NC>(a, re, im, lt);\n        __syncwarp();\n"
         "        pass<NC, 32, 32>(a, re, im, A.tw, lt);\n        __syncwarp();\n"
         "      } else {\n        fft_regs<NC>(a, re, im, A.tw, lt);\n      }\n"
         "      for (int k = lt;"),
    ],
    "window by __ldg": [
        ("  const float2* win2 = reinterpret_cast<const float2*>(win);",
         "  const float2* win2 = reinterpret_cast<const float2*>(A.win);"),
        ("const float2 v = x2[t], w = win2[t];", "const float2 v = x2[t], w = __ldg(win2 + t);"),
        ("        const float2 w = win2[t];", "        const float2 w = __ldg(win2 + t);"),
    ],
    "8-frame tiles": [("constexpr int kTileF = 16;", "constexpr int kTileF = 8;")],
    "no FFT": [(K2_FFT, "      if (A.n < 0) fft_regs<NC>(a, re, im, A.tw, lt, w1, w8);")],
    "no epilogue": [
        (K2_SPLIT, "      if (A.n < 0) {\n#pragma unroll\n      for (int j = 0; j < 32; ++j) {"),
        (K2_SPLIT_END, "      }\n      } else {\n        float s_ = 0.f;\n#pragma unroll\n"
                       "        for (int j = 0; j < 32; ++j) s_ += a[j].x + a[j].y;\n"
                       "        pw[lt] = s_;\n      }\n      if (lt == 0 && A.kmax > NC) {"),
        (K2_MEL, "    if (f < A.F && A.n < 0) {"),
    ],
}
K2_EDITS["neither"] = K2_EDITS["no FFT"] + K2_EDITS["no epilogue"]
K2_CHECKED = ("shipped", "path 2", "shared split", "window by __ldg", "8-frame tiles")


def compile_variants(build, source: str, edits: dict, tmp: Path, record: dict) -> dict:
    """Compile a copy of ``source`` and the headers for each named list of
    (old, new) line edits, each applied to the one file that holds it;
    returns name -> path of the library."""
    files = {p.name: p.read_text() for p in [build.HERE / source, *build.HERE.glob("*.cuh")]}
    out = {}
    for name, changes in edits.items():
        texts = dict(files)
        for old, new in changes:
            holders = [f for f, t in texts.items() if old in t]
            assert len(holders) == 1, (name, old, holders)
            texts[holders[0]] = texts[holders[0]].replace(old, new)
        d = tmp / f"{Path(source).stem}-{len(list(tmp.iterdir()))}"
        d.mkdir()
        for f, t in texts.items():
            (d / f).write_text(t)
        res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                              str(d / source)], capture_output=True, text=True)
        assert res.returncode == 0, (name, res.stdout, res.stderr)
        record["ptxas"][f"{source} {name}"] = [ln.strip() for ln in res.stdout.splitlines()
                                               if "registers" in ln or "spill" in ln]
        out[name] = d / "lib.so"
    return out


def plan_path(plan, *args) -> int:
    """The path a build's plan function (``mfcc_fft_plan`` or
    ``ct_mel_plan``) picks for its arguments."""
    info = (ctypes.c_longlong * 5)()
    assert plan(*args, info) == 0, args
    return info[0]


def time_in_turns(torch, cuda_ms, runs: dict, flush) -> dict:
    times = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        times[k] += cuda_ms(torch, runs[k], 25, flush)
    return times


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
    from mfcc_rust_tpu_torch import api as PA
    from mfcc_rust_tpu_torch.ops.cuda import build
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length

    rng = np.random.default_rng(0)
    cfg = P.speechpy_config(16000)
    t = bucket_length(160000)
    x = torch.from_numpy(rng.normal(0.0, 0.1, (48, t)).astype(np.float32)).cuda()
    frames = (t - cfg.frame_size) // cfg.frame_step
    record = {"card": smi("name,power.limit"), "shape": [48, t], "rel": {}, "ptxas": {},
              "k2": {"rel": {}, "path_rule": {}}}
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=x.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def padded(au, c):
        """(the centre-padded, bucketed batch of ``au`` that ``api``'s graph
        computes on, its uncentred config)."""
        write, shape, cu, _ = PA._writer(torch.from_numpy(au), c, True, x.device)
        return write(torch.empty(shape, device=x.device)), cu

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # ------------------------------------------------------------ K1 --
        libs = {"shipped": k1._lib()}
        for name, path in compile_variants(build, "speechpy_mfcc.cu", EDITS, tmp, record).items():
            libs[name] = k1._bind(ctypes.CDLL(str(path)))
        _, wp, _, _, km = k1._kernel_constants(cfg)
        k1_args = (cfg.fft_points, cfg.frame_step, cfg.frame_size, km, wp.size, cfg.num_filters,
                   48 * -(-frames // k1._TILE_F))
        assert [plan_path(libs[k].mfcc_fft_plan, *k1_args) for k in ("shipped", "path 2")] == [1, 2]
        ref = k1.mfcc_fused_plain(x, cfg)
        outs = {k: torch.empty((48, frames, cfg.num_cepstral), device=x.device) for k in libs}
        runs = {k: (lambda k=k: k1._launch(libs[k], x, cfg, outs[k])) for k in libs}
        for k in CHECKED:
            runs[k]()
            torch.cuda.synchronize()
            record["rel"][k] = rel_err(outs[k], ref)[0]
        assert record["rel"]["shipped"] <= 1e-4 and record["rel"]["path 2"] <= 1e-4, record["rel"]
        times = time_in_turns(torch, cuda_ms, runs, flush_buf.zero_)
        record["times_ms"] = times
        record["median_ms"] = {k: statistics.median(v) for k, v in times.items()}
        print("K1", json.dumps(record["median_ms"]), flush=True)

        # ------------------------------------------------------------ K2 --
        libs2 = {"shipped": k2._lib()}
        for name, path in compile_variants(build, "ct_mel.cu", K2_EDITS, tmp, record).items():
            libs2[name] = k2._bind(ctypes.CDLL(str(path)))

        def k2_runs(c, xb, names):
            f = 1 + (xb.shape[1] - c.fft_points) // c.frame_step
            outs2 = {k: torch.empty((xb.shape[0], f, c.num_filters), device=xb.device)
                     for k in names}

            def run(k):
                err = k2._launch(libs2[k], xb, c, outs2[k], stream())
                assert err == 0, (k, libs2[k].ct_mel_error_string(err))
            # the launch plan of each build takes the path its name claims
            _, _, wp, _, km = k2._kernel_constants(c)
            n = c.fft_points
            args = (n, c.frame_step, km, wp.size, c.num_filters, xb.shape[0], f,
                    k2.frames_per_block(n, wp.size))
            for k in names:
                if k in ("shipped", "path 2"):
                    want = 2 if k == "path 2" else k2.fft_path(*args[:5])
                    assert plan_path(libs2[k].ct_mel_plan, *args) == want, (k, n)
            return outs2, {k: (lambda k=k: run(k)) for k in names}

        audio = rng.normal(0.0, 0.1, (32, 220500)).astype(np.float32)
        xb, cb = padded(audio, P.librosa_config(22050))
        ref2 = k2.ct_mel_plain(xb, cb)
        outs2, runs2 = k2_runs(cb, xb, list(libs2))
        for k in K2_CHECKED:
            runs2[k]()
            torch.cuda.synchronize()
            record["k2"]["rel"][k] = rel_err(outs2[k], ref2)[0]
        assert record["k2"]["rel"]["shipped"] <= 1e-4 and record["k2"]["rel"]["path 2"] <= 1e-4, \
            record["k2"]["rel"]
        times2 = time_in_turns(torch, cuda_ms, runs2, flush_buf.zero_)
        record["k2"]["shape"] = list(xb.shape)
        record["k2"]["times_ms"] = times2
        record["k2"]["median_ms"] = {k: statistics.median(v) for k, v in times2.items()}
        print("K2", json.dumps(record["k2"]["median_ms"]), flush=True)

        # ---------------------------------------------- K2's path rule --
        for label, c, rate, batch, secs in (
                ("128/32", P.librosa_config(8000, n_fft=128, hop_length=32, n_mels=20), 8000, 48,
                 10),
                ("256/64", P.librosa_config(8000, n_fft=256, n_mels=40), 8000, 48, 10),
                ("512/160/80", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
                 16000, 48, 10),
                ("1024/256", P.librosa_config(16000, n_fft=1024, hop_length=256), 16000, 48, 10),
                ("2048/512", P.librosa_config(22050), 22050, 32, 10),
                ("400/160/128", P.librosa_config(16000, n_fft=400, hop_length=160, n_mels=128),
                 16000, 64, 30)):
            au = rng.normal(0.0, 0.1, (batch, secs * rate)).astype(np.float32)
            xr, cr = padded(au, c)
            refr = k2.ct_mel_plain(xr, cr)
            outr, runr = k2_runs(cr, xr, ["shipped", "path 2"])
            rels = {}
            for k in runr:
                runr[k]()
                torch.cuda.synchronize()
                rels[k] = rel_err(outr[k], refr)[0]
                assert rels[k] <= 1e-4, (label, k, rels[k])
            tr = time_in_turns(torch, cuda_ms, runr, flush_buf.zero_)
            record["k2"]["path_rule"][label] = {
                "shape": list(xr.shape), "rel": rels, "times_ms": tr,
                "median_ms": {k: statistics.median(v) for k, v in tr.items()}}
            print("K2 path rule", label, json.dumps(record["k2"]["path_rule"][label]["median_ms"]),
                  flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "k1_experiments.json").write_text(json.dumps(record, indent=1))
    print(record["card"])
    print(json.dumps({"card": record["card"], "k1": {"rel": record["rel"],
                                                     "median_ms": record["median_ms"]},
                      "k2": {"rel": record["k2"]["rel"], "median_ms": record["k2"]["median_ms"],
                             "path_rule": {k: v["median_ms"] for k, v in
                                           record["k2"]["path_rule"].items()}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
