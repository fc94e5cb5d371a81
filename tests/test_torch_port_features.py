"""The PyTorch port's speechpy main path (plain path, on the CPU) against the
JAX reference on the same seeded inputs, and against the float64 speechpy
oracle.

Tolerances: max|Δ| / max|ref| <= 1e-5 in float32 (two float32 programs that
sum in different orders), <= 1e-9 in float64, and the reference's 5e-3
float32 gate against the float64 oracle.  Log-MFE alone is held to 3e-5 in
float32: the log turns the rounding of a small band energy into its
relative error, and on these inputs the JAX float32 log-MFE itself lies up
to 1.6e-5 from its float64 value."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import features as JF
from tests.golden import speechpy_ref as sp

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.ops import spectrum as pspec

TOL = {"float32": 1e-5, "float64": 1e-9}
LOG_TOL = {"float32": 3e-5, "float64": 1e-9}

CONFIGS = [
    ("default 20/10", {}, 16000),
    ("25/10", {"frame_length": 0.025}, 16000),
    ("preemph 0.97", {"preemphasis_cof": 0.97}, 16000),
    ("no dc_elim", {"dc_elimination": False}, 9000),
    ("r=1 10/10", {"frame_length": 0.01}, 16000),
    ("batched 3-D", {}, (2, 2, 6000)),
    ("T < fl", {}, 300),
]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pair(cfg_kw, shape, dtype, seed=0):
    """(JAX config, port config, JAX input, port input) on one numpy draw."""
    jcfg = m.speechpy_config(16000, dtype=dtype, **cfg_kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    x = np.random.default_rng(seed).normal(0, 0.1, shape).astype(dtype)
    return jcfg, pcfg, jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_main_path_matches_jax(name, kw, shape, dtype):
    jcfg, pcfg, jx, px = _pair(kw, shape, dtype)
    tol = TOL[dtype]
    jf, je = JF.mfe(jx, jcfg)
    pf, pe = PF.mfe(px, pcfg)
    assert pf.dtype == getattr(torch, dtype)
    assert rel(pf, jf) <= tol and rel(pe, je) <= tol, name
    assert rel(PF.lmfe(px, pcfg), JF.lmfe(jx, jcfg)) <= LOG_TOL[dtype], name
    out = PF.mfcc(px, pcfg)
    assert rel(out, JF.mfcc(jx, jcfg)) <= tol, name
    if name == "T < fl":
        assert out.shape == (0, 13)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_main_path_matches_golden_oracle(dtype):
    x = np.random.default_rng(1).normal(0, 0.1, 16000)
    cfg = P.speechpy_config(16000, dtype=dtype)
    out = PF.mfcc(torch.from_numpy(x.astype(dtype)), cfg).numpy()
    gold = sp.mfcc(x, 16000)
    assert out.shape == gold.shape == (98, 13)
    assert rel(out, gold) <= (5e-3 if dtype == "float32" else 1e-9)
    gf, ge = sp.mfe(x, 16000)
    pf, pe = PF.mfe(torch.from_numpy(x.astype(dtype)), cfg)
    assert rel(pf, gf) <= (5e-3 if dtype == "float32" else 1e-9)
    assert rel(pe, ge) <= (5e-3 if dtype == "float32" else 1e-9)


@pytest.mark.parametrize("frame_length", [0.02, 0.025, 0.01])
def test_chunk_gemm_forms_agree(frame_length):
    cfg = P.speechpy_config(16000, frame_length=frame_length, dtype="float64")
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.1, (2, 4000)))
    wall = PF._speechpy_tensors(cfg, x.device, x.dtype)["wall"]
    n_frames = (4000 - cfg.frame_size) // cfg.frame_step
    ch_a, ya = PF._chunk_gemm(x, wall, n_frames, cfg.frame_step, fuse=True)
    ch_b, yb = PF._chunk_gemm(x, wall, n_frames, cfg.frame_step, fuse=False)
    assert torch.equal(ch_a, ch_b)
    assert rel(ya, yb) <= 1e-12


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ssc_branch_matches_jax(dtype):
    """_chunked_mel_energy's SSC branch (the frequency ramp as spectral
    weight), float64 eps substitution included."""
    jcfg, pcfg, jx, px = _pair({}, 12000, dtype, seed=3)
    ramp = np.linspace(1.0, 8000.0, jcfg.freq_size)
    jn, _, jd = JF._chunked_mel_energy(jx, jcfg, want_energy=False, spectral_weight=ramp)
    pn, _, pd = PF._chunked_mel_energy(px, pcfg, want_energy=False, ssc=True)
    assert rel(pn, jn) <= TOL[dtype] and rel(pd, jd) <= TOL[dtype]
    assert rel(pn / pd, sp.ssc(np.asarray(jx, np.float64), 16000)) <= (
        5e-3 if dtype == "float32" else 1e-9)


@pytest.mark.parametrize("kw", [{"fft_impl": "fft"}, {"window": "hann"},
                                {"frame_length": 0.04}, {"frame_length": 0.005}],
                         ids=["fft impl", "hann", "frame > fft", "frame < hop"])
def test_gather_fallback_and_windowed_paths_match_jax(kw):
    """Configs off the rect chunk-GEMM path: the gather fallback, and the
    windowed Parseval product."""
    jcfg, pcfg, jx, px = _pair(kw, 8000, "float64", seed=4)
    assert rel(PF.mfcc(px, pcfg), JF.mfcc(jx, jcfg)) <= 1e-9
    jf, je = JF.mfe(jx, jcfg)
    pf, pe = PF.mfe(px, pcfg)
    assert rel(pf, jf) <= 1e-9 and rel(pe, je) <= 1e-9


def test_ct_impl_not_ported_yet():
    """fft_points > 1024 resolves to the Cooley-Tukey rFFT, which the port
    computes as the reference does."""
    jcfg, pcfg, jx, px = _pair({"fft_points": 2048, "frame_length": 0.1}, 8000, "float64", seed=16)
    assert pspec.resolve_fft_impl(pcfg) == "ct"
    assert rel(PF.mfcc(px, pcfg), JF.mfcc(jx, jcfg)) <= 1e-9


def test_primitives_match_jax():
    from mfcc_rust_tpu.ops import framing as jframing

    x = np.random.default_rng(5).normal(0, 1, (2, 1000))
    np.testing.assert_allclose(
        pframing.preemphasis(torch.from_numpy(x), 1, 0.97).numpy(),
        np.asarray(jframing.preemphasis(jnp.asarray(x), 1, 0.97)), rtol=0, atol=1e-15)
    for zp in (True, False):
        a = pframing.stack_frames(torch.from_numpy(x), 16000, 0.025, 0.01, zero_padding=zp)
        b = jframing.stack_frames(jnp.asarray(x), 16000, 0.025, 0.01, zero_padding=zp)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for length in (0, 399, 400, 401, 16000):
        assert pframing.speechpy_frame_counts(length, 400, 160, False) == \
            jframing.speechpy_frame_counts(length, 400, 160, False)
    zh = pspec.zero_handling(torch.tensor([0.0, 1.0], dtype=torch.float64))
    assert zh[0].item() == float(np.finfo(np.float32).eps)
    cfg = m.speechpy_config(16000, fft_points=1024, dtype="float64")
    frames = np.random.default_rng(6).normal(0, 1, (5, 320))
    for impl in ("matmul", "fft"):
        got = pspec.power_spectrum(torch.from_numpy(frames),
                                   P.from_reference(dataclasses.asdict(cfg.replace(fft_impl=impl))))
        ref = np.abs(np.fft.rfft(frames, 1024)) ** 2 / 1024
        assert rel(got, ref) <= 1e-12


def test_api_matches_jax_api():
    x = np.random.default_rng(7).normal(0, 0.1, 12345).astype(np.float32)
    assert rel(P.mfcc(x, 16000, device="cpu"), japi.mfcc(x, 16000)) <= 1e-5
    pf, pe = P.mfe(x, 16000, device="cpu")
    jf, je = japi.mfe(x, 16000)
    assert rel(pf, jf) <= 1e-5 and rel(pe, je) <= 1e-5
    assert rel(P.lmfe(x, 16000, frame_length=0.025, device="cpu"),
               japi.lmfe(x, 16000, frame_length=0.025)) <= LOG_TOL["float32"]
    # tensors go in as well as arrays, and bucketing only pads
    assert rel(P.mfcc(torch.from_numpy(x), 16000, bucket=False, device="cpu"),
               japi.mfcc(x, 16000)) <= 1e-5
    assert P.mfcc(x[:100], 16000, device="cpu").shape == (0, 13)


def test_pipelines_match_features():
    cfg = P.speechpy_config(16000, frame_length=0.025)
    x = torch.from_numpy(np.random.default_rng(8).normal(0, 0.1, (2, 8000)).astype(np.float32))
    pipe = P.MFCCPipeline(cfg, device="cpu")
    assert {n for n, _ in pipe.named_buffers()} >= {"wall", "proj", "dct"}
    assert torch.equal(pipe(x), PF.mfcc(x, cfg))
    f, e = P.MFEPipeline(cfg, device="cpu")(x)
    rf, re_ = PF.mfe(x, cfg)
    assert torch.equal(f, rf) and torch.equal(e, re_)
    assert torch.equal(P.LogMFEPipeline(cfg, device="cpu")(x), PF.lmfe(x, cfg))
    # a config off the chunk-GEMM path holds no buffers and still runs
    gather = P.MFCCPipeline(cfg.replace(fft_impl="fft"), device="cpu")
    assert len(list(gather.buffers())) == 0
    assert rel(gather(x), PF.mfcc(x, cfg)) <= 1e-5


def test_grad_matches_jax():
    import jax

    jcfg, pcfg, jx, px = _pair({"preemphasis_cof": 0.97}, 4000, "float64", seed=9)
    gj = jax.grad(lambda s: JF.mfcc(s, jcfg).sum())(jx)
    px.requires_grad_(True)
    PF.mfcc(px, pcfg).sum().backward()
    assert rel(px.grad, gj) <= 1e-9


def test_bucketing_and_mel_orientation_match_jax():
    from mfcc_rust_tpu.ops import mel as jmel
    from mfcc_rust_tpu.utils import bucketing as jb

    from mfcc_rust_tpu_torch.ops import mel as pmel
    from mfcc_rust_tpu_torch.utils import bucketing as pb

    for n in (1, 2048, 2049, 12345, 160000, 177664, 10**7):
        assert pb.bucket_length(n) == jb.bucket_length(n)
    x = np.ones((2, 3000))
    (pa, na), (ja, nb) = pb.pad_to_bucket(x), jb.pad_to_bucket(x)
    assert na == nb and np.array_equal(pa, ja)
    lengths = [100, 5000, 2100, 2047, 90000, 5001, 3]
    assert pb.bucket_batch(lengths, 2) == jb.bucket_batch(lengths, 2)
    cfg = m.speechpy_config(16000, dtype="float64")
    power = np.random.default_rng(10).random((2, 7, cfg.freq_size))
    got = pmel.mel_project_time_major(torch.from_numpy(power), P.from_reference(dataclasses.asdict(cfg)))
    assert rel(got, jmel.mel_project_time_major(jnp.asarray(power), cfg)) <= 1e-12
