"""The PyTorch port's entry points, speechpy compat layer, pipelines,
``FeatureExtractor`` and ``nn.Module`` transforms on the CPU against the JAX
package's on the same seeded inputs, and the port's export list.

Tolerances (max|Δ|/max|ref|): <= 1e-5 in float32 (3e-5 for log-mel
quantities, see tests/test_torch_port_features.py), <= 1e-9 in float64."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import torch_compat as jtc
from mfcc_rust_tpu.compat import speechpy as jsp
from tests.golden import speechpy_ref as sp

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch import transforms as T
from mfcc_rust_tpu_torch.compat import speechpy as psp

CPU = {"device": "cpu"}


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def sig():
    return np.random.default_rng(0).normal(0, 0.1, 15357).astype(np.float32)


@pytest.fixture(scope="module")
def feat():
    return np.random.default_rng(1).normal(1.0, 2.0, (60, 13))


def test_exports_match_reference():
    import inspect

    import mfcc_rust_tpu.models as jm

    # functions and classes (submodules depend on what else this process
    # imported), and the three subpackages the reference's __init__ names
    want = {n for n, v in vars(m).items() if not n.startswith("_") and not inspect.ismodule(v)}
    have = {n for n in vars(P) if not n.startswith("_")}
    assert want - have == set()
    assert all(inspect.ismodule(getattr(P, n)) for n in ("constants", "features", "ops"))
    for name in ("SSCPipeline", "MelSpectrogramPipeline", "FeatureExtractor"):
        assert hasattr(jm, name) and hasattr(P, name)


# (entry point, positional args after the signal, keywords); float32 input
FEATURE_CALLS = [
    ("ssc", (16000,), {}),
    ("ssc", (16000,), {"frame_length": 0.025, "num_filters": 26}),
    ("mel_spectrogram", (16000,), {}),
    ("mel_spectrogram", (16000,), {"frame_length": 0.01, "bucket": False}),
]


@pytest.mark.parametrize("name,args,kw", FEATURE_CALLS,
                         ids=[f"{c[0]} {c[2]}" for c in FEATURE_CALLS])
def test_feature_entry_points_match_jax(sig, name, args, kw):
    got = getattr(P, name)(sig, *args, **kw, **CPU)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert rel(got, getattr(japi, name)(sig, *args, **kw)) <= 1e-5


def test_extract_entry_point_matches_jax(sig):
    for which in (("mfcc",), ("lmfe", "ssc"), ("mfe", "energy", "mfcc")):
        got = P.extract(sig, 16000, which=which, **CPU)
        ref = japi.extract(sig, 16000, which=which)
        assert got.keys() == ref.keys()
        for k in got:
            a, b = (got[k], ref[k]) if k != "mfe" else (got[k][0], ref[k][0])
            assert rel(a, b) <= (3e-5 if k == "lmfe" else 1e-5), k


# (entry point, args after the input, keywords) of the post-processing API
POST_CALLS = [
    ("derivative_extraction", (), {}),
    ("derivative_extraction", (3,), {}),
    ("extract_derivative_feature", (), {}),
    ("delta", (), {}),
    ("delta", (), {"width": 4}),
    ("delta_librosa", (), {"width": 5, "order": 2, "axis": 0}),
    ("cmvn", (True,), {}),
    ("cmvnw", (), {"win_size": 21, "variance_normalization": True}),
    ("cmvnw", (), {}),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,args,kw", POST_CALLS,
                         ids=[f"{c[0]} {c[1]} {c[2]}" for c in POST_CALLS])
def test_post_entry_points_match_jax_and_keep_dtype(feat, name, args, kw, dtype):
    x = feat.astype(dtype)
    got = getattr(P, name)(x, *args, **kw, **CPU)
    assert got.dtype == getattr(torch, dtype)
    assert rel(got, getattr(japi, name)(x, *args, **kw)) <= (1e-5 if dtype == "float32" else 1e-9)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_framing_entry_points_match_jax(sig, dtype):
    x = sig.astype(dtype)
    tol = 1e-5 if dtype == "float32" else 1e-9
    pre = P.preemphasis(x, 1, 0.97, **CPU)
    assert pre.dtype == getattr(torch, dtype) and rel(pre, japi.preemphasis(x, 1, 0.97)) <= tol
    for zp in (True, False):
        fr = P.stack_frames(x, 16000, 0.025, 0.01, zp, **CPU)
        assert rel(fr, japi.stack_frames(x, 16000, 0.025, 0.01, zp)) == 0.0
    frames = P.stack_frames(x, 16000, zero_padding=False, **CPU)
    for norm in (True, False):
        lps = P.log_power_spectrum(frames, 512, norm, **CPU)
        ref = japi.log_power_spectrum(frames.numpy(), 512, norm)
        assert rel(lps, ref) <= (3e-5 if dtype == "float32" else 1e-9)
    # normalized by the maximum of the whole array, not of each row
    lps = P.log_power_spectrum(frames, **CPU)
    assert float(lps.max()) == 0.0 and bool((lps.amax(-1) < 0).any())
    assert rel(lps, sp.log_power_spectrum(frames.double().numpy(), 512)) <= (
        5e-3 if dtype == "float32" else 1e-9)


def test_new_entry_points_need_cuda_unless_asked(sig, feat):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    calls = [(P.ssc, (sig, 16000)), (P.extract, (sig, 16000)),
             (P.mel_spectrogram, (sig, 16000)), (P.preemphasis, (sig,)),
             (P.derivative_extraction, (feat,)), (P.extract_derivative_feature, (feat,)),
             (P.delta, (feat,)), (P.delta_librosa, (feat,)),
             (P.log_power_spectrum, (feat,)), (P.stack_frames, (sig, 16000)),
             (P.cmvn, (feat,)), (P.cmvnw, (feat,)), (P.resample, (sig, 16000, 8000)),
             (P.resample_poly, (sig, 1, 2)), (psp.processing.cmvn, (feat,)),
             (psp.feature.ssc, (sig, 16000))]
    for fn, args in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.FeatureExtractor()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.SSCPipeline(P.speechpy_config(16000))


# ----------------------------------------------------------- speechpy compat --
def test_compat_feature_matches_jax_compat(sig):
    for name in ("mfcc", "lmfe", "ssc"):
        got = getattr(psp.feature, name)(sig, 16000, **CPU)
        assert rel(got, getattr(jsp.feature, name)(sig, 16000)) <= (
            3e-5 if name == "lmfe" else 1e-5), name
    f, e = psp.feature.mfe(sig, 16000, **CPU)
    jf, je = jsp.feature.mfe(sig, 16000)
    assert rel(f, jf) <= 1e-5 and rel(e, je) <= 1e-5
    mf = psp.feature.mfcc(sig, 16000, **CPU)
    assert rel(psp.feature.extract_derivative_feature(mf, **CPU),
               jsp.feature.extract_derivative_feature(mf.numpy())) <= 1e-5
    np.testing.assert_array_equal(psp.feature.filterbanks(40, 257, 16000),
                                  jsp.feature.filterbanks(40, 257, 16000))


def test_compat_processing_matches_jax_compat(sig, feat):
    frames = psp.processing.stack_frames(sig, 16000, 0.02, 0.01, zero_padding=False, **CPU)
    assert frames.dtype == torch.float32
    assert rel(frames, jsp.processing.stack_frames(sig, 16000, 0.02, 0.01,
                                                   zero_padding=False)) == 0.0
    hann = lambda n: 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    fw = psp.processing.stack_frames(sig, 16000, 0.02, 0.01, hann, False, **CPU)
    assert fw.dtype == torch.float64  # the filter gives a float64 window
    assert rel(fw, jsp.processing.stack_frames(sig, 16000, 0.02, 0.01, hann, False)) <= 1e-12
    for name in ("fft_spectrum", "power_spectrum"):
        got = getattr(psp.processing, name)(frames, 512, **CPU)
        assert rel(got, getattr(jsp.processing, name)(frames.numpy(), 512)) <= 1e-5, name
    assert rel(psp.processing.preemphasis(sig, 1, 0.97, **CPU),
               jsp.processing.preemphasis(sig, 1, 0.97)) <= 1e-6
    assert rel(psp.processing.derivative_extraction(feat, 2, **CPU),
               jsp.processing.derivative_extraction(feat, DeltaWindows=2)) <= 1e-9
    assert rel(psp.processing.derivative_extraction(feat, DeltaWindows=3, **CPU),
               sp.derivative_extraction(feat, 3)) <= 1e-9
    assert rel(psp.processing.cmvn(feat, True, **CPU), jsp.processing.cmvn(feat, True)) <= 1e-9
    assert rel(psp.processing.cmvnw(feat, 31, True, **CPU),
               jsp.processing.cmvnw(feat, 31, True)) <= 1e-9
    assert rel(psp.processing.log_power_spectrum(frames, 512, **CPU),
               jsp.processing.log_power_spectrum(frames.numpy(), 512)) <= 1e-5


# ----------------------------------------------------------------- modules --
def test_ssc_pipeline_and_feature_extractor(sig):
    cfg = P.speechpy_config(16000, frame_length=0.025)
    x = torch.from_numpy(sig[:8000].reshape(2, 4000))
    pipe = P.SSCPipeline(cfg, device="cpu")
    assert {n for n, _ in pipe.named_buffers()} >= {"wall", "proj", "ssc"}
    assert torch.equal(pipe(x), PF.ssc(x, cfg))
    fe = P.FeatureExtractor(cfg, device="cpu")
    assert isinstance(fe, torch.nn.Module)
    assert {n for n, _ in fe.named_children()} == {"mfcc", "mfe", "lmfe", "ssc",
                                                   "mel_spectrogram"}
    assert torch.equal(fe(x), PF.mfcc(x, cfg))
    assert torch.equal(fe.ssc(x), PF.ssc(x, cfg))
    assert torch.equal(fe.lmfe(x), PF.lmfe(x, cfg))
    assert torch.equal(fe.mel_spectrogram(x), PF.mel_spectrogram(x, cfg.replace(window="vorbis")))
    jfe = m.models.FeatureExtractor(m.speechpy_config(16000, frame_length=0.025))
    assert rel(fe(x), jfe(x.numpy())) <= 1e-5
    assert rel(fe.ssc(x), jfe.ssc(x.numpy())) <= 1e-5
    assert rel(fe.mel_spectrogram(x), jfe.mel_spectrogram(x.numpy())) <= 1e-5
    default = P.FeatureExtractor(sample_rate=8000, device="cpu")
    assert default.cfg == P.FeatureConfig(sample_rate=8000)


TRANSFORMS = [
    ("MelSpectrogram", (), {"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 40}),
    ("MFCC", (), {"sr": 22050, "n_mfcc": 13}),
    ("SpeechpyMFCC", (16000,), {"num_cepstral": 20}),
]


@pytest.mark.parametrize("name,args,kw", TRANSFORMS, ids=[c[0] for c in TRANSFORMS])
def test_transforms_match_jax_transforms_and_carry_grad(sig, name, args, kw):
    x = torch.from_numpy(sig[:12000].reshape(2, 6000))
    mod = getattr(T, name)(*args, **kw)
    out = mod(x)
    ref = getattr(jtc, name)(*args, **kw)(x)
    # librosa MFCC is log-mel: 3e-5
    assert rel(out, ref) <= (3e-5 if name == "MFCC" else 1e-5)
    assert out.device == x.device and "=" in repr(mod)
    xg = x.clone().requires_grad_(True)
    pipe = torch.nn.Sequential(mod)
    pipe(xg).sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
