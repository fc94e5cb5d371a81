"""The CT mel kernel module of the PyTorch port
(``mfcc_rust_tpu_torch/ops/cuda/ct_mel.py``).

On the CPU its plain version, ``ct_mel_plain``, is held against the JAX
Pallas kernel ``ct_mel_pallas`` run in interpret mode (as
``tests/test_pallas.py`` runs it) at max|Δ|/max|ref| <= 1e-5: two float32
programs that sum in different orders, on different factorizations.  The
CUDA kernel itself runs only on the card: ``tests/test_torch_port_cuda.py``
holds it to the plain version there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu import constants as jc
from mfcc_rust_tpu.ops import fft as jfft
from mfcc_rust_tpu.ops.pallas import ct_mel as jk

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import fft as pfft
from mfcc_rust_tpu_torch.ops.cuda import build
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as pk

# (name, librosa_config kwargs, input shape); the TPU kernel takes the
# chunk layout for 2048/512 and the frames layout for the others
CONFIGS = [
    ("2048/512 chunks", dict(sample_rate=22050), (2, 22050)),
    ("512/160/80 frames", dict(sample_rate=16000, n_fft=512, hop_length=160, n_mels=80),
     (2, 16000)),
    ("2048/768 frames", dict(sample_rate=16000, n_fft=2048, hop_length=768), (2, 16000)),
    ("1-D", dict(sample_rate=22050), (11025,)),
    ("3-D", dict(sample_rate=22050), (2, 2, 5000)),
    ("uncentred", dict(sample_rate=22050, center=False), (2, 9000)),
    ("short, uncentred", dict(sample_rate=22050, center=False), (100,)),
]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _cfgs(kw):
    center = kw.pop("center", True)
    jcfg = m.librosa_config(**kw).replace(center=center)
    return jcfg, P.from_reference(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_plain_matches_jax_kernel(name, kw, shape):
    jcfg, pcfg = _cfgs(dict(kw))
    x = np.random.default_rng(30).normal(0, 0.1, shape).astype(np.float32)
    ref = np.asarray(jk.ct_mel_pallas(jnp.asarray(x), jcfg, interpret=True))
    out = pk.ct_mel_plain(torch.from_numpy(x), pcfg)
    assert out.dtype == torch.float32
    assert rel(out, ref) <= 1e-5, name
    if name == "short, uncentred":
        assert out.shape == (0, 128)


@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_cpu_tensor_never_touches_the_kernel(name, kw, shape):
    """On a CPU tensor the wrapper is the plain version, the dispatch takes
    a plain lowering, and nothing is built, loaded or launched."""
    _, pcfg = _cfgs(dict(kw))
    x = torch.from_numpy(np.random.default_rng(31).normal(0, 0.1, shape).astype(np.float32))
    before = pk.ct_mel.launches
    assert torch.equal(pk.ct_mel(x, pcfg), pk.ct_mel_plain(x, pcfg))
    assert not PF._librosa_kernel_ok(x, pcfg)
    mel = PF.mel_spectrogram_librosa(x, pcfg)
    assert pk.ct_mel.launches == before
    assert pk._lib.cache_info().currsize == 0 and pk.KERNEL not in build._loaded
    assert rel(pk.ct_mel_plain(x, pcfg).transpose(-1, -2), mel) <= 1e-5, name


SUPPORT = [
    ("2048/512", dict(sample_rate=22050)),
    ("1024/256", dict(sample_rate=16000, n_fft=1024, hop_length=256)),
    ("512/160/80", dict(sample_rate=16000, n_fft=512, hop_length=160, n_mels=80)),
    ("512/130/64", dict(sample_rate=16000, n_fft=512, hop_length=130, n_mels=64)),
    ("2048/768", dict(sample_rate=16000, n_fft=2048, hop_length=768)),
    ("2048/100", dict(sample_rate=22050, hop_length=100)),
    ("256/64", dict(sample_rate=8000, n_fft=256, n_mels=40)),
    ("768/192", dict(sample_rate=16000, n_fft=768, n_mels=64)),
    ("1280/320", dict(sample_rate=16000, n_fft=1280)),
    ("4096/1024", dict(sample_rate=44100, n_fft=4096)),
    ("384/128, no TPU factorization", dict(sample_rate=16000, n_fft=384, hop_length=128)),
    ("power 1", dict(sample_rate=22050, power=1.0)),
]


@pytest.mark.parametrize("name,kw", SUPPORT, ids=[s[0] for s in SUPPORT])
def test_support_covers_the_tpu_kernel(name, kw):
    jcfg, pcfg = _cfgs(dict(kw))
    if jk.pallas_ct_supported(jcfg):
        assert pk.ct_mel_supported(pcfg), name
    if pk.ct_mel_supported(pcfg):
        m_odd, n4, has2 = pk.fft_plan(pcfg.fft_points)
        assert m_odd % 2 == 1 and m_odd * 4 ** n4 * 2 ** has2 == pcfg.fft_points // 2
        _, _, wpack, _, kmax = pk._kernel_constants(pcfg)
        nnz = wpack.size
        g = pk.frames_per_block(pcfg.fft_points, nnz)
        assert 1 <= g <= 8 and pk.smem_bytes(pcfg.fft_points, g, nnz) <= 232448
        args = (pcfg.fft_points, pcfg.frame_step, kmax, nnz, pcfg.num_filters)
        nc = pcfg.fft_points // 2
        assert pk.path_for(pcfg) == (1 if nc in (64, 128, 256, 512, 1024) else 2), name
        if pk.path_for(pcfg) == 1:
            w = pk.fft_warps(*args)
            assert w == 8 and pk.fft_smem_bytes(*args, w) <= 232448, name
    assert pk.ct_mel_supported(pcfg) == (pcfg.power == 2.0)


def test_support_refuses_speechpy_framing_odd_and_huge_frames():
    assert not pk.ct_mel_supported(P.speechpy_config(16000))
    assert not pk.ct_mel_supported(P.librosa_config(16000, n_fft=511))
    assert not pk.ct_mel_supported(P.librosa_config(48000, n_fft=32768))
    assert pk.fft_plan(2048) == (1, 5, 0) and pk.fft_plan(768) == (3, 3, 1)
    with pytest.raises(ValueError):
        pk.ct_mel(torch.zeros(8000), P.speechpy_config(16000))


@pytest.mark.parametrize("n,n1,n2,k1max", [(2048, 128, 16, 64), (2048, 32, 64, 17),
                                           (512, 32, 16, 16), (768, 32, 24, 17)])
def test_ct_constant_copies_equal_reference(n, n1, n2, k1max):
    for a, b in zip(jfft._ct_constants(n, n1, n2), pfft._ct_constants(n, n1, n2)):
        assert np.array_equal(a, b)
    for a, b in zip(jfft._ct_foldtw_matrices(n, n1, n2, k1max),
                    pfft._ct_foldtw_matrices(n, n1, n2, k1max)):
        assert np.array_equal(a, b)
    for a, b in zip(jfft._ct_stage_matrices(n, n1, n2, k1max),
                    pfft._ct_stage_matrices(n, n1, n2, k1max)):
        assert np.array_equal(a, b)
    assert np.array_equal(jfft._ct_bin_permutation(n, n1, n2),
                          pfft._ct_bin_permutation(n, n1, n2))
    assert jfft.good_factorization(n) == pfft.good_factorization(n)
    cfg = m.librosa_config(16000, n_fft=n)
    fb = jc.constant_bundle(cfg)["fbank"]
    fb_nyq = fb.copy()
    fb_nyq[:, n // 2] = 1.0  # a Nyquist weight keeps the k1 == N1/2 plane
    for w in (fb, fb_nyq):
        assert np.array_equal(jfft.permute_weights_for_ct(w, n, (n1, n2)),
                              pfft.permute_weights_for_ct(w, n, (n1, n2)))


@pytest.mark.parametrize("n,hop", [(254, 100), (1000, 441)])
def test_plain_matches_numpy_without_a_balanced_factorization(n, hop):
    """Even sizes the reference cannot factor (254 = 2 x 127) or whose odd
    part the kernel transforms directly (1000 = 125 x 8), odd hops too."""
    cfg = P.librosa_config(8000, n_fft=n, hop_length=hop, n_mels=20, dtype="float64")
    assert pk.ct_mel_supported(cfg)
    x = np.random.default_rng(33).normal(0, 0.1, 3000)
    xp = np.pad(x, n // 2, mode="reflect")
    count = 1 + (len(xp) - n) // hop
    frames = np.stack([xp[f * hop: f * hop + n] for f in range(count)])
    bundle = P.constants.constant_bundle(cfg)
    ref = (np.abs(np.fft.rfft(frames * bundle["window"])) ** 2) @ bundle["fbank"].T
    out = pk.ct_mel_plain(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12 * ref.max())


@pytest.mark.parametrize("kw", [dict(sample_rate=22050), dict(sample_rate=16000, n_fft=512,
                                hop_length=160, n_mels=80, fmin=300.0, fmax=3000.0)])
def test_packed_filterbank_rebuilds_the_dense_one(kw):
    cfg = P.librosa_config(**kw)
    _, _, wpack, ranges, kmax = pk._kernel_constants(cfg)
    fb = P.constants.constant_bundle(cfg)["fbank"]
    dense = np.zeros_like(fb, dtype=np.float32)
    for m, (lo, hi, off) in enumerate(ranges):
        dense[m, lo:hi] = wpack[off:off + hi - lo]
    assert np.array_equal(dense, fb.astype(np.float32))
    assert kmax == P.constants.constant_bundle(cfg)["fbank_kmax"] == ranges[:, 1].max()


def test_autograd_function_matches_plain_grad():
    """The kernel's autograd.Function (its forward is the plain version on
    the CPU) recomputes its backward through the plain path."""
    cfg = P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)
    x = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (2, 4000)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    out = PF._MelLibrosaKernel.apply(a, cfg)
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out * w).sum().backward()
    b = x.clone().requires_grad_(True)
    (PF.mel_spectrogram_librosa(b, cfg.replace(pallas="off")).transpose(-1, -2) * w).sum().backward()
    assert rel(a.grad, b.grad) <= 1e-4
