"""The PyTorch port's vorbis ("DFN") batch STFT and the reference's mel
spectrogram (plain paths, on the CPU) against the JAX reference on the same
seeded inputs, and against the stateful frame-by-frame float64 oracle
``tests/golden/dfn_ref.py`` and its frozen fixtures.

Tolerances (max|Δ|/max|ref|): <= 1e-5 in float32, <= 1e-9 in float64, the
reference's 5e-3 float32 gate against the oracle, and autograd gradients at
1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import features as JF
from mfcc_rust_tpu.ops import stft as jstft
from tests.golden import dfn_ref
from tests.golden.gen_fixtures import FIXTURE_DIR, fixture_inputs

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import spectrum as pspec
from mfcc_rust_tpu_torch.ops import stft as pstft

TOL = {"float32": 1e-5, "float64": 1e-9}
DTYPES = ["float32", "float64"]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pair(shape, dtype, seed=0, **kw):
    jcfg = m.vorbis_config(16000, dtype=dtype, **kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    x = np.random.default_rng(seed).normal(0, 0.1, shape).astype(dtype)
    return jcfg, pcfg, jnp.asarray(x), torch.from_numpy(x)


def test_vorbis_config_equals_reference():
    for rate, kw in ((16000, {}), (48000, {"fft_points": 960, "frame_length": 0.01}),
                     (16000, {"frame_length": 0.008})):
        jcfg, pcfg = m.vorbis_config(rate, **kw), P.vorbis_config(rate, **kw)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
        assert (pcfg.stream_hop, pcfg.stream_n_pad, pcfg.wnorm) == \
            (jcfg.stream_hop, jcfg.stream_n_pad, jcfg.wnorm)
    from mfcc_rust_tpu import constants as jc

    from mfcc_rust_tpu_torch import constants as pc

    for n, n_in in ((40, 13), (26, None), (128, 40)):
        assert np.array_equal(pc.idct_matrix(n, n_in), jc.idct_matrix(n, n_in))


# (name, config kwargs, length): 20 ms at 512 (n_pad 0), 10 ms (n_pad 2),
# 8 ms (n_pad 3), a partial last chunk
STFT = [("20 ms", {}, 16000), ("10 ms, n_pad 2", {"frame_length": 0.01}, 9000),
        ("8 ms, n_pad 3", {"frame_length": 0.008}, 4000),
        ("partial chunk", {}, 15999)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kw,t", STFT, ids=[c[0] for c in STFT])
def test_stft_vorbis_power_matches_jax_and_oracle(name, kw, t, dtype):
    jcfg, pcfg, jx, px = _pair(t, dtype, seed=1, **kw)
    got = pstft.stft_vorbis_power(px, pcfg)
    assert got.dtype == px.dtype
    assert rel(got, jstft.stft_vorbis_power(jx, jcfg)) <= TOL[dtype], name
    gold = np.abs(dfn_ref.stft1(np.asarray(jx, np.float64), 512, None, 16000,
                                jcfg.frame_length)) ** 2
    assert rel(got, gold) <= (5e-3 if dtype == "float32" else 1e-9), name
    n_pad = pcfg.stream_n_pad
    if n_pad:  # the never-written tail rows
        assert float(got[-n_pad:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_stft_vorbis_complex_matches_jax_and_oracle(dtype):
    jcfg, pcfg, jx, px = _pair((2, 8000), dtype, seed=2, frame_length=0.01)
    got = pstft.stft_vorbis(px, pcfg)
    assert got.is_complex()
    ref = np.asarray(jstft.stft_vorbis(jx, jcfg))
    assert rel(got.real, ref.real) <= TOL[dtype] and rel(got.imag, ref.imag) <= TOL[dtype]
    gold = dfn_ref.stft2(np.asarray(jx, np.float64), 512, None, 16000, 0.01)
    tol = 5e-3 if dtype == "float32" else 1e-9
    assert rel(got.real, gold.real) <= tol and rel(got.imag, gold.imag) <= tol


def test_npad_layout_matches_jax():
    cfg = m.vorbis_config(16000, frame_length=0.008)
    frames = np.random.default_rng(3).normal(size=(2, 7, 5))
    for c in (cfg, cfg.replace(frame_length=0.02)):
        got = pstft._apply_npad_layout(torch.from_numpy(frames),
                                       P.from_reference(dataclasses.asdict(c)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jstft._apply_npad_layout(
            jnp.asarray(frames), c)))


def test_stft_fixture():
    sig16, _, _ = fixture_inputs()
    cfg = P.vorbis_config(16000, frame_length=0.01, dtype="float64")
    got = pstft.stft_vorbis_power(torch.from_numpy(sig16[:8000]), cfg)
    assert rel(got, np.load(FIXTURE_DIR / "dfn_stft_power.npy")) <= 1e-9


# (name, config kwargs, shape): the matmul chunk-GEMM lowering and the
# framed STFT (fft impl) for 1-D and 2-D input
MEL = [("matmul 1-D", {}, (16000,)), ("matmul 2-D", {}, (3, 12000)),
       ("matmul 10 ms", {"frame_length": 0.01}, (2, 9999)),
       ("matmul 8 ms, short", {"frame_length": 0.008}, (2, 900)),
       ("fft impl 1-D", {"fft_impl": "fft"}, (16000,)),
       ("fft impl 2-D, 10 ms", {"fft_impl": "fft", "frame_length": 0.01}, (2, 9999)),
       ("speechpy window given", {"window": "rect"}, (2, 8000))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,kw,shape", MEL, ids=[c[0] for c in MEL])
def test_mel_spectrogram_matches_jax_and_oracle(name, kw, shape, dtype):
    kw = dict(kw)
    window = kw.pop("window", None)
    jcfg = m.vorbis_config(16000, dtype=dtype, **kw)
    if window:  # a speechpy config: the function takes the vorbis window anyway
        jcfg = m.speechpy_config(16000, dtype=dtype, **kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    x = np.random.default_rng(4).normal(0, 0.1, shape).astype(dtype)
    got = PF.mel_spectrogram(torch.from_numpy(x), pcfg)
    assert got.dtype == getattr(torch, dtype)
    ref = JF.mel_spectrogram(jnp.asarray(x), jcfg)
    assert rel(got, ref) <= TOL[dtype], name
    lowering = "matmul" if "fft_impl" not in kw else "fft"
    assert pspec.resolve_fft_impl(pcfg.replace(window="vorbis")) == lowering
    x64 = x.astype(np.float64)
    fl = pcfg.frame_length
    gold = (dfn_ref.mel_spectrogram1(x64, 16000, frame_length=fl) if x.ndim == 1
            else dfn_ref.mel_spectrogram2(x64, 16000, frame_length=fl))
    assert rel(got, gold) <= (5e-3 if dtype == "float32" else 1e-9), name


def test_mel_spectrogram_fixture():
    sig16, _, _ = fixture_inputs()
    got = PF.mel_spectrogram(torch.from_numpy(sig16), P.vorbis_config(16000, dtype="float64"))
    assert rel(got, np.load(FIXTURE_DIR / "dfn_melspec.npy")) <= 1e-9


def test_mel_spectrogram_grad_matches_jax():
    jcfg, pcfg, jx, px = _pair((2, 4000), "float64", seed=5, frame_length=0.01)
    w = np.random.default_rng(9).random((2, 40, 25))
    a = px.clone().requires_grad_(True)
    (PF.mel_spectrogram(a, pcfg) * torch.from_numpy(w)).sum().backward()
    gj = jax.grad(lambda s: (JF.mel_spectrogram(s, jcfg) * w).sum())(jx)
    assert rel(a.grad, gj) <= 1e-5


@pytest.mark.parametrize("bucket", [True, False])
def test_api_mel_spectrogram_matches_jax_and_oracle(bucket):
    rng = np.random.default_rng(6)
    s1 = rng.normal(0, 0.1, 12000).astype(np.float32)
    s2 = rng.normal(0, 0.1, (2, 9999)).astype(np.float32)
    for sig, kw in ((s1, {}), (s2, {"frame_length": 0.01})):
        got = P.mel_spectrogram(sig, 16000, bucket=bucket, device="cpu", **kw)
        assert rel(got, japi.mel_spectrogram(sig, 16000, bucket=bucket, **kw)) <= 1e-5
        fl = kw.get("frame_length", 0.02)
        x64 = sig.astype(np.float64)
        gold = (dfn_ref.mel_spectrogram1(x64, 16000, frame_length=fl) if sig.ndim == 1
                else dfn_ref.mel_spectrogram2(x64, 16000, frame_length=fl))
        assert rel(got, gold) <= 5e-3
    with pytest.raises(ValueError, match="1-D or 2-D"):
        P.mel_spectrogram(np.zeros((2, 2, 100), np.float32), 16000, device="cpu")


@pytest.mark.parametrize("bucket", [True, False])
def test_api_mel_spectrogram_short_clip_is_zero(bucket):
    """256 samples at hop 128 (frame_length 8 ms, n_pad 3): two output
    frames, both of them among the reference's never-written tail rows.  The
    JAX entry point's negative slice start leaves row 0 of the bucketed
    result non-zero; the port clamps it, as the oracle has it."""
    sig = np.random.default_rng(7).normal(0, 0.1, 256).astype(np.float32)
    got = P.mel_spectrogram(sig, 16000, frame_length=0.008, bucket=bucket, device="cpu")
    gold = dfn_ref.mel_spectrogram1(sig.astype(np.float64), 16000, frame_length=0.008)
    assert got.shape == gold.shape == (40, 2)
    assert float(got.abs().max()) == 0.0 and np.abs(gold).max() == 0.0
    jref = japi.mel_spectrogram(sig, 16000, frame_length=0.008, bucket=bucket)
    if bucket:  # the fault in the reference that the port does not copy
        assert np.abs(jref[:, 0]).max() > 0.0
    else:
        assert np.abs(jref).max() == 0.0


def test_mel_spectrogram_pipeline():
    x = torch.from_numpy(np.random.default_rng(8).normal(0, 0.1, (2, 8000)).astype(np.float32))
    pipe = P.MelSpectrogramPipeline(P.speechpy_config(16000), device="cpu")
    assert pipe.cfg.window == "vorbis" and len(list(pipe.buffers())) == 0
    assert torch.equal(pipe(x), PF.mel_spectrogram(x, P.vorbis_config(16000)))


@pytest.mark.parametrize("fft_impl", ["auto", "fft"])
def test_mel_spectrogram_empty_clip_matches_jax(fft_impl):
    """No samples: only the n_pad zero rows of the reference's layout."""
    jcfg = m.vorbis_config(16000, frame_length=0.01, fft_impl=fft_impl)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    got = PF.mel_spectrogram(torch.zeros((2, 0)), pcfg)
    ref = np.asarray(JF.mel_spectrogram(jnp.zeros((2, 0), jnp.float32), jcfg))
    assert got.shape == ref.shape == (2, 40, 2) and float(got.abs().max()) == 0.0
