"""The PyTorch port's librosa mel / log-mel / MFCC path (plain path, on the
CPU) against the JAX reference on the same seeded inputs, and against the
float64 librosa oracle ``tests/golden/librosa_ref.py``.

Tolerances: float64 at rtol 1e-6 (the parity contract of docs/PARITY.md);
float32 at rtol 1e-4, atol 1e-6 (two float32 programs that sum in different
orders); the oracle's float32 gate rtol 5e-3, atol 1e-4·max."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import features as JF
from mfcc_rust_tpu import models as JM
from mfcc_rust_tpu.ops import fft as jfft
from mfcc_rust_tpu.ops import spectrum as jspec
from mfcc_rust_tpu.ops import stft as jstft
from tests.golden import librosa_ref as lr

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import fft as pfft
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.ops import spectrum as pspec
from mfcc_rust_tpu_torch.ops import stft as pstft

TOL = {"float64": dict(rtol=1e-6, atol=0.0), "float32": dict(rtol=1e-4, atol=1e-6)}

# (name, librosa_config kwargs, the plain lowering the config takes)
BRANCHES = [
    ("ct 2048/512", dict(sample_rate=22050), "ct"),
    ("chunk-GEMM 1024/256", dict(sample_rate=16000, n_fft=1024, hop_length=256), "chunk"),
    ("hop-padded 512/160/80", dict(sample_rate=16000, n_fft=512, hop_length=160, n_mels=80),
     "hoppad"),
    ("stft_framed fft impl", dict(sample_rate=22050, fft_impl="fft"), "framed"),
]
VARIANTS = [
    ("base", {}, {}),
    ("power 1", {"power": 1.0}, {}),
    ("uncentred", {}, {"center": False}),
    ("win_length < n_fft", {"win_length": 256}, {}),
]


def _close(a, ref, dtype):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    np.testing.assert_allclose(a, ref, **TOL[dtype])


def _pair(kw, dtype, **replace):
    jcfg = m.librosa_config(**kw).replace(dtype=dtype, **replace)
    return jcfg, P.from_reference(dataclasses.asdict(jcfg))


def _branch(cfg) -> str:
    if PF._librosa_ct_ok(cfg):
        return "ct"
    if PF._fast_path_ok(cfg) and cfg.fft_points % cfg.frame_step == 0:
        return "chunk"
    return "hoppad" if PF._librosa_hoppad_ok(cfg) else "framed"


@pytest.fixture(scope="module")
def clip():
    t = np.arange(22050) / 22050.0
    noise = np.random.default_rng(20).normal(size=t.shape)
    return 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t) + 0.05 * noise


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("vname,ckw,rkw", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("name,kw,branch", BRANCHES, ids=[b[0] for b in BRANCHES])
def test_mel_branches_match_jax(name, kw, branch, vname, ckw, rkw, dtype):
    jcfg, pcfg = _pair({**kw, **ckw}, dtype, **rkw)
    if vname != "power 1":
        assert _branch(pcfg) == branch, name
    x = np.random.default_rng(21).normal(0, 0.1, (2, 9000)).astype(dtype)
    out = PF.mel_spectrogram_librosa(torch.from_numpy(x), pcfg)
    assert out.dtype == getattr(torch, dtype)
    _close(out, JF.mel_spectrogram_librosa(jnp.asarray(x), jcfg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_log_mel_mfcc_and_power_to_db_match_jax(dtype):
    jcfg, pcfg = _pair(dict(sample_rate=22050), dtype)
    x = np.random.default_rng(22).normal(0, 0.1, (2, 3, 7000)).astype(dtype)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    _close(PF.log_mel_spectrogram(px, pcfg), JF.log_mel_spectrogram(jx, jcfg), dtype)
    _close(PF.log_mel_spectrogram(px, pcfg, ref=2.0, top_db=None),
           JF.log_mel_spectrogram(jx, jcfg, ref=2.0, top_db=None), dtype)
    _close(PF.mfcc_librosa(px, pcfg), JF.mfcc_librosa(jx, jcfg), dtype)
    # per_spectrogram: the top_db maximum over the trailing two axes of a
    # batch (each spectrogram its own), over the whole array otherwise
    s = np.abs(np.random.default_rng(23).normal(0, 1.0, (2, 4, 5))).astype(dtype) ** 8
    s[1] *= 1e-6
    for a in (s, s[0]):
        for per in (True, False):
            _close(pspec.power_to_db(torch.from_numpy(a), per_spectrogram=per),
                   jspec.power_to_db(jnp.asarray(a), per_spectrogram=per), dtype)


@pytest.mark.parametrize("bucket", [True, False])
def test_api_matches_jax_api(bucket):
    x = np.random.default_rng(24).normal(0, 0.1, (2, 23000)).astype(np.float32)
    _close(P.mel_spectrogram_librosa(x, bucket=bucket, device="cpu"),
           japi.mel_spectrogram_librosa(x, bucket=bucket), "float32")
    _close(P.log_mel_spectrogram(x, 16000, n_fft=512, hop_length=160, n_mels=80,
                                 bucket=bucket, device="cpu"),
           japi.log_mel_spectrogram(x, 16000, n_fft=512, hop_length=160, n_mels=80,
                                    bucket=bucket), "float32")
    _close(P.mfcc_librosa(x[0], n_mfcc=13, center=False, bucket=bucket, device="cpu"),
           japi.mfcc_librosa(x[0], n_mfcc=13, center=False, bucket=bucket), "float32")


def test_api_short_uncentred_clip_has_no_frames():
    """A clip shorter than one frame, uncentred, has no frames whether it is
    bucketed or not (the unbucketed reference's answer).  The frame count
    would be negative here, and slicing the bucketed result by it would keep
    frames of bucket zeros; the dB heads return an empty result where the
    top_db maximum of nothing would raise."""
    x = np.random.default_rng(34).normal(0, 0.1, 100).astype(np.float32)
    kw = dict(sr=16000, n_fft=512, hop_length=128, center=False)
    ref = japi.mel_spectrogram_librosa(x, bucket=False, **kw)
    assert ref.shape == (128, 0)
    for bucket in (True, False):
        _close(P.mel_spectrogram_librosa(x, bucket=bucket, device="cpu", **kw), ref, "float32")
        assert P.mfcc_librosa(x, n_mfcc=13, bucket=bucket, device="cpu",
                              **kw).shape == (13, 0)
        assert P.log_mel_spectrogram(x, bucket=bucket, device="cpu", **kw).shape == (128, 0)
    assert pstft.librosa_frame_count(100, 512, 128, False) == 0


def test_float64_oracle(clip):
    cfg = P.librosa_config(22050).replace(dtype="float64")
    x = torch.from_numpy(clip)
    mel = PF.mel_spectrogram_librosa(x, cfg).numpy()
    gold = lr.melspectrogram(clip, 22050, 2048, 512)
    assert mel.shape == gold.shape == (128, 44)
    np.testing.assert_allclose(mel, gold, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(PF.log_mel_spectrogram(x, cfg).numpy(),
                               lr.power_to_db(gold), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(PF.mfcc_librosa(x, cfg).numpy(), lr.mfcc(clip, 22050),
                               rtol=1e-6, atol=1e-6)
    # the production dtype through the entry point, at the oracle's float32 gate
    got = P.mel_spectrogram_librosa(clip.astype(np.float32), device="cpu").numpy()
    np.testing.assert_allclose(got, gold, rtol=5e-3, atol=1e-4 * gold.max())


@pytest.mark.parametrize("length", [1, 5, 100, 1023])
def test_reflect_pad_of_short_signal(length):
    """A pad at least as long as the signal reflects again and again, as
    np.pad and jnp.pad do; a clip shorter than n_fft/2 gives JAX's frames."""
    x = np.random.default_rng(25).normal(0, 0.1, length).astype(np.float32)
    for mode in ("reflect", "symmetric", "edge", "wrap", "constant"):
        np.testing.assert_array_equal(
            pframing.pad_signal(torch.from_numpy(x), 1024, 1024, mode).numpy(),
            np.pad(x, 1024, mode=mode))
    jcfg, pcfg = _pair(dict(sample_rate=22050), "float32")
    out = PF.mel_spectrogram_librosa(torch.from_numpy(x), pcfg)
    assert out.shape == (128, 1 + length // 512)
    _close(out, JF.mel_spectrogram_librosa(jnp.asarray(x), jcfg), "float32")


@pytest.mark.parametrize("n_fft,factors", [(2048, None), (512, None), (768, (32, 24)),
                                           (1024, (16, 64))])
def test_rfft_ct_matches_numpy(n_fft, factors):
    frames = np.random.default_rng(26).normal(0, 1, (3, 5, n_fft - 7))
    xr, xi = pfft.rfft_ct(torch.from_numpy(frames), n_fft, factors)
    ref = np.fft.rfft(frames, n_fft)
    np.testing.assert_allclose(xr.numpy(), ref.real, rtol=0, atol=1e-10)
    np.testing.assert_allclose(xi.numpy(), ref.imag, rtol=0, atol=1e-10)
    jr, ji = jfft.rfft_ct(jnp.asarray(frames), n_fft, factors)
    np.testing.assert_allclose(xr.numpy(), np.asarray(jr), rtol=0, atol=1e-10)


@pytest.mark.parametrize("style", ["librosa", "speechpy_nopad", "speechpy_pad"])
@pytest.mark.parametrize("power", [2.0, 1.0])
def test_stft_framed_matches_jax(style, power):
    jcfg, pcfg = _pair(dict(sample_rate=16000, n_fft=512, hop_length=160, power=power),
                       "float64")
    x = np.random.default_rng(27).normal(0, 0.1, (2, 5000))
    _close(pstft.stft_framed(torch.from_numpy(x), pcfg, style),
           jstft.stft_framed(jnp.asarray(x), jcfg, style), "float64")
    _close(pstft.stft_framed(torch.from_numpy(x), pcfg, style, return_power=False),
           jstft.stft_framed(jnp.asarray(x), jcfg, style, return_power=False), "float64")
    for length in (0, 100, 512, 5000):
        assert pstft.librosa_frame_count(length, 512, 160, True) == \
            jstft.librosa_frame_count(length, 512, 160, True)


def test_librosa_pipelines_match_features():
    x = torch.from_numpy(np.random.default_rng(28).normal(0, 0.1, (2, 9000)).astype(np.float32))
    cfg = P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)
    # this config is on the speechpy chunk-GEMM fast path too; the librosa
    # pipelines must not take speechpy constants
    assert PF._fast_path_ok(cfg)
    mel = P.LibrosaMelPipeline(cfg, device="cpu")
    assert len(list(mel.buffers())) == 0
    assert torch.equal(mel(x), PF.mel_spectrogram_librosa(x, cfg))
    mf = P.LibrosaMFCCPipeline(P.librosa_config(), device="cpu")
    assert torch.equal(mf(x), PF.mfcc_librosa(x, P.librosa_config()))
    jm = JM.LibrosaMelPipeline(m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80))
    _close(mel(x), jm(jnp.asarray(x.numpy())), "float32")


def test_speechpy_mfcc_at_fft_2048_matches_jax():
    """fft_length 2048 resolves to the Cooley-Tukey rFFT in both packages."""
    x = np.random.default_rng(29).normal(0, 0.1, 16000).astype(np.float32)
    out = P.mfcc(x, 16000, fft_length=2048, device="cpu")
    ref = m.mfcc(x, 16000, fft_length=2048)
    assert out.shape == ref.shape == (98, 13)
    assert float(np.abs(out.numpy() - ref).max() / np.abs(ref).max()) <= 1e-5


def test_frame_size_other_than_n_fft_raises():
    cfg = P.speechpy_config(16000)
    with pytest.raises(ValueError, match="frames by fft_points"):
        PF.mel_spectrogram_librosa(torch.zeros(8000), cfg)
