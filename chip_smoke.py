#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mfcc_rust_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Builds the port's kernels from the sources in this checkout, drives the main
path (``mfcc_rust_tpu_torch.mfcc`` on a B=48 x 10 s batch at 16 kHz, the
speechpy MFCC-13 default) once with every launch count set to 0, and fails
unless each kernel of that path launched.  Then it holds each kernel to its
plain PyTorch version on the card (rel-err <= 1e-4: the kernel sums in
another order than cuBLAS), the main path to the float64 speechpy oracle of
``tests/golden/speechpy_ref.py`` (<= 5e-3, the reference's float32 gate),
the autograd gradient to the plain path's, and times the kernel, its plain
version and the unfused chunk-GEMM path with CUDA events.

Any failed check raises, so the exit code is not 0.  Without a CUDA device
it exits 1 before printing any result.  The last lines are the card's
``nvidia-smi`` name and power limit, one ``{"kernels": [...]}`` JSON line,
and ``{"ok": true, "device": {...}}``.  With ``--out DIR`` the full
record (every timing sample) also goes to ``DIR/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BATCH, SECONDS, RATE = 48, 10, 16000
REL_TOL = 1e-4
ORACLE_TOL = 5e-3


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def rel_err(a, ref) -> tuple:
    """(max|a - ref| / max|ref|, max|a - ref|) of two tensors."""
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (tuple(a.shape), tuple(ref.shape))
    if ref.numel() == 0:
        return 0.0, 0.0
    d = (a - ref).abs().max().item()
    return d / ref.abs().max().item(), d


def cuda_ms(torch, fn, reps: int, flush) -> list:
    """Per-call device times in ms (CUDA events), each call after an L2
    flush: the main path meets a freshly uploaded batch, not a warm cache."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, help="directory for chip_smoke.json")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mfcc_rust_tpu_torch as P
    from mfcc_rust_tpu_torch import features as PF
    from mfcc_rust_tpu_torch.ops import framing
    from mfcc_rust_tpu_torch.ops.cuda import build
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
    from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
    from tests.golden import speechpy_ref

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    record = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- build --
    t0 = time.perf_counter()
    logs = build.build([k1.KERNEL])
    record["build_s"] = time.perf_counter() - t0
    log(f"build: {k1.KERNEL} in {record['build_s']:.3f} s")
    for line in logs[k1.KERNEL].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    lib = k1._lib()
    cfg = P.speechpy_config(RATE)
    wall, _, _, _, r, hop, fl = k1._mfcc_constants(cfg)
    m, c = cfg.num_filters, cfg.num_cepstral
    for mc in (cfg, cfg.replace(frame_length=0.025), cfg.replace(fft_points=1024)):
        wc, _, _, _, rc, hc, _ = k1._mfcc_constants(mc)
        assert lib.mfcc_fused_smem_bytes(hc, rc, mc.num_filters, wc.shape[1]) == \
            k1.smem_bytes(hc, rc, mc.num_filters, wc.shape[1]), "smem mirror"

    # ------------------------------------------------------ main path, once --
    rng = np.random.default_rng(0)
    t_true = SECONDS * RATE
    audio = rng.normal(0.0, 0.1, (BATCH, t_true)).astype(np.float32)
    k1.mfcc_fused.launches = 0
    t0 = time.perf_counter()
    feats = P.mfcc(audio, RATE)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = k1.mfcc_fused.launches
    n_frames = (t_true - fl) // hop
    assert feats.is_cuda and feats.shape == (BATCH, n_frames, 13), tuple(feats.shape)
    assert bool(torch.isfinite(feats).all()), "non-finite MFCC"
    if launches < 1:
        raise AssertionError("the main path did not launch the speechpy_mfcc kernel")
    log(f"main path: mfcc({BATCH} x {t_true}) -> {tuple(feats.shape)} in {first_s:.3f} s "
        f"(first call); {k1.KERNEL} launches: {launches}")

    # ------------------------------------- K1 against its plain version -----
    t_main = bucket_length(t_true)  # the length the main path hands the kernel
    x = torch.from_numpy(audio).to(dev)
    x_main = torch.nn.functional.pad(x, (0, t_main - t_true))
    out_k = k1.mfcc_fused(x_main, cfg)
    out_p = k1.mfcc_fused_plain(x_main, cfg)
    torch.cuda.synchronize()
    headline_rel, headline_abs = rel_err(out_k, out_p)
    log(f"K1 vs plain at ({BATCH}, {t_main}): rel {headline_rel:.3e} abs {headline_abs:.3e}")
    assert headline_rel <= REL_TOL, headline_rel
    assert rel_err(feats, out_k[:, :n_frames])[0] == 0.0, "main path differs from the kernel"

    small = [
        ("25/10 r=3", cfg.replace(frame_length=0.025), (2, 16000)),
        ("10/10 r=1", cfg.replace(frame_length=0.01), (2, 16000)),
        ("dc_elimination=False", cfg.replace(dc_elimination=False), (2, 16000)),
        ("preemphasis 0.97", cfg.replace(preemphasis_cof=0.97), (2, 16000)),
        ("fft 1024, W > 288 in two passes", cfg.replace(fft_points=1024), (2, 16000)),
        ("batched 3-D", cfg, (2, 3, 8000)),
        ("T < fl", cfg, (300,)),
    ]
    record["small"] = {}
    for name, scfg, shape in small:
        xs = torch.from_numpy(rng.normal(0.0, 0.1, shape).astype(np.float32)).to(dev)
        before = k1.mfcc_fused.launches
        got = PF.mfcc(xs, scfg)
        xp = framing.preemphasis(xs, 1, scfg.preemphasis_cof) if scfg.preemphasis_cof else xs
        ref = k1.mfcc_fused_plain(xp, scfg)
        chunk = PF.mfcc(xs, scfg.replace(pallas="off"))
        torch.cuda.synchronize()
        r1, a1 = rel_err(got, ref)
        r2, _ = rel_err(got, chunk)
        want = 0 if got.shape[-2] == 0 else 1
        assert k1.mfcc_fused.launches - before == want, name
        assert r1 <= REL_TOL and r2 <= REL_TOL, (name, r1, r2)
        if name == "T < fl":
            assert got.shape == (0, 13), tuple(got.shape)
        record["small"][name] = {"rel": r1, "abs": a1, "rel_vs_chunk_gemm": r2,
                                 "shape": list(got.shape)}
        log(f"K1 vs plain, {name} {shape}: rel {r1:.3e} (vs chunk-GEMM path {r2:.3e}) "
            f"-> {tuple(got.shape)}")

    # ------------------------------------------- main path vs the oracle ----
    sig = rng.normal(0.0, 0.1, RATE)
    gold = speechpy_ref.mfcc(sig, RATE)
    got = P.mfcc(sig.astype(np.float32), RATE)
    oracle_rel, _ = rel_err(got, torch.from_numpy(gold))
    log(f"api.mfcc vs float64 speechpy oracle: rel {oracle_rel:.3e} (limit {ORACLE_TOL})")
    assert oracle_rel <= ORACLE_TOL, oracle_rel

    # --------------------------------------------------------- autograd -----
    xg = torch.from_numpy(rng.normal(0.0, 0.1, (2, 16000)).astype(np.float32)).to(dev)
    a = xg.clone().requires_grad_(True)
    before = k1.mfcc_fused.launches
    PF.mfcc(a, cfg).sum().backward()
    assert k1.mfcc_fused.launches == before + 1
    b = xg.clone().requires_grad_(True)
    PF.mfcc(b, cfg.replace(pallas="off")).sum().backward()
    grad_rel, _ = rel_err(a.grad, b.grad)
    log(f"grad through the kernel vs the plain path: rel {grad_rel:.3e}")
    assert grad_rel <= REL_TOL, grad_rel

    # ----------------------------------------------------------- timing -----
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    flush = lambda: flush_buf.zero_()
    off = cfg.replace(pallas="off")
    runs = {"kernel": lambda: k1.mfcc_fused(x_main, cfg),
            "plain": lambda: k1.mfcc_fused_plain(x_main, cfg),
            "chunk_gemm": lambda: PF.mfcc(x_main, off)}
    times = {k: [] for k in runs}
    for order in (("plain", "kernel", "chunk_gemm"), ("chunk_gemm", "kernel", "plain")):
        for k in order:
            times[k] += cuda_ms(torch, runs[k], 10, flush)
    med = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: (max(v) - min(v)) / statistics.median(v) for k, v in times.items()}
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        P.mfcc(audio, RATE)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    api_s = statistics.median(host)
    clocks = smi("clocks.sm,power.draw,power.limit,temperature.gpu")

    f_main = (t_main - fl) // hop
    kdim, w = wall.shape
    flops = 2.0 * BATCH * f_main * (kdim * w + w * (m + 1) + m * c)
    nbytes = 4.0 * (BATCH * t_main + BATCH * f_main * c + kdim * w + w * (m + 1) + m * c)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    audio_s = BATCH * SECONDS
    log(f"times at ({BATCH}, {t_main}), median of {len(times['kernel'])} (rel spread): "
        + ", ".join(f"{k} {med[k]:.4f} ms ({spread[k]:.3f})" for k in runs))
    log(f"K1 work: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; bound {bound_ms:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / med['kernel'] / 1e9:.3f} TFLOP/s achieved")
    log(f"audio-s/s: kernel {audio_s / med['kernel'] * 1e3:.1f}, "
        f"chunk-GEMM path {audio_s / med['chunk_gemm'] * 1e3:.1f}, "
        f"api.mfcc from host numpy {audio_s / api_s:.1f} ({api_s * 1e3:.3f} ms)")
    log(f"clocks.sm, power.draw, power.limit, temperature: {clocks}")

    kernels = [{
        "name": k1.KERNEL, "route": "cuda",
        "source": "mfcc_rust_tpu_torch/ops/cuda/speechpy_mfcc.cu",
        "replaces": "mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py:155",
        "launches": launches, "max_abs_err": headline_abs,
        "ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    record.update({
        "main_path": {"shape": [BATCH, t_true], "bucket": t_main, "launches": launches,
                      "first_call_s": first_s, "api_ms": api_s * 1e3, "api_ms_all": [h * 1e3 for h in host]},
        "headline": {"rel": headline_rel, "abs": headline_abs},
        "oracle_rel": oracle_rel, "grad_rel": grad_rel,
        "times_ms": times, "median_ms": med, "flops": flops, "bytes": nbytes,
        "clocks": clocks, "kernels": kernels,
    })
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
