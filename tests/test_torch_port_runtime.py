"""The PyTorch port's copy of the native runtime (``mfcc_rust_tpu_torch.runtime``):
WAV codec round-trips and the prefetch loader, the cases of
tests/test_runtime.py on the port's copy, plus its sources pinned byte-equal
to the reference's and its decode held bitwise to the reference's.

Tolerances: PCM16 round trips within one quantization step (1/10000 for a
mono clip, 1/8000 for a stereo mixdown), the scipy fallback within 1e-6;
decodes of one file by the two packages are bitwise equal."""

from pathlib import Path

import numpy as np
import pytest

from mfcc_rust_tpu import runtime as jrt

from mfcc_rust_tpu_torch.runtime import (AudioLoader, native_available, read_wav, wav_info,
                                         write_wav)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_wavs")
    lengths = [1600, 16000, 7777, 3201]
    clips = []
    for i, n in enumerate(lengths):
        clip = (0.5 * np.sin(2 * np.pi * 220 * (i + 1) * np.arange(n) / 16000)).astype(
            np.float32
        )
        write_wav(str(d / f"clip{i}.wav"), clip, 16000)
        clips.append(clip)
    return d, clips


@pytest.mark.parametrize("name", ["wav_io.cpp", "prefetch.cpp"])
def test_sources_byte_equal_to_reference(name):
    ours = ROOT / "mfcc_rust_tpu_torch" / "runtime" / "src" / name
    ref = ROOT / "mfcc_rust_tpu" / "runtime" / "src" / name
    assert ours.read_bytes() == ref.read_bytes()


def test_native_compiles():
    assert native_available(), "g++ native runtime failed to build"
    from mfcc_rust_tpu_torch.runtime import build

    lib = Path(build.load_native()._name)
    assert lib.parent == ROOT / "mfcc_rust_tpu_torch" / "runtime" / "_build"


def test_roundtrip_mono(wav_dir):
    d, clips = wav_dir
    for i, clip in enumerate(clips):
        out, sr = read_wav(str(d / f"clip{i}.wav"))
        assert sr == 16000
        assert out.shape == clip.shape
        np.testing.assert_allclose(out, clip, atol=1.0 / 10000)


def test_decode_bitwise_equal_to_reference(wav_dir, tmp_path):
    d, clips = wav_dir
    stereo = np.random.default_rng(3).normal(0, 0.2, (5000, 2)).astype(np.float32).clip(-1, 1)
    jrt.write_wav(str(tmp_path / "st.wav"), stereo, 8000)
    files = [d / f"clip{i}.wav" for i in range(len(clips))] + [tmp_path / "st.wav"]
    for f in files:
        for mix in (True, False):
            a, sa = read_wav(str(f), mix_mono=mix)
            b, sb = jrt.read_wav(str(f), mix_mono=mix)
            assert sa == sb and a.dtype == b.dtype and np.array_equal(a, b), (f, mix)
    # and files written by the port decode bitwise as the reference's
    x = np.random.default_rng(4).normal(0, 0.1, 999).astype(np.float32)
    write_wav(str(tmp_path / "p.wav"), x, 16000)
    jrt.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_wav_info(wav_dir):
    d, clips = wav_dir
    info = wav_info(str(d / "clip1.wav"))
    assert info.sample_rate == 16000
    assert info.channels == 1
    assert info.bits_per_sample == 16
    assert info.frames == len(clips[1])


def test_stereo_mixdown(tmp_path):
    stereo = np.random.default_rng(5).normal(0, 0.2, (5000, 2)).astype(np.float32).clip(-1, 1)
    p = str(tmp_path / "st.wav")
    write_wav(p, stereo, 8000)
    mono, sr = read_wav(p, mix_mono=True)
    assert sr == 8000 and mono.shape == (5000,)
    np.testing.assert_allclose(mono, stereo.mean(axis=1), atol=1.0 / 8000)
    both, _ = read_wav(p, mix_mono=False)
    assert both.shape == (5000, 2)


def test_max_frames_truncation(wav_dir):
    d, clips = wav_dir
    out, _ = read_wav(str(d / "clip1.wav"), max_frames=1000)
    assert out.shape == (1000,)
    np.testing.assert_allclose(out, clips[1][:1000], atol=1.0 / 10000)


def test_loader_yields_all(wav_dir):
    d, clips = wav_dir
    paths = [str(d / f"clip{i}.wav") for i in range(len(clips))]
    seen = {}
    order = []
    ref = list(jrt.AudioLoader(paths, n_threads=3, capacity=2))
    for idx, samples, sr, meta in AudioLoader(paths, n_threads=3, capacity=2):
        assert sr == 16000
        assert meta.pcm16_exact  # write_wav emits mono PCM16
        seen[idx] = samples
        order.append(idx)
    # deterministic in-path-order emission (reorder buffer)
    assert order == list(range(len(clips)))
    for i, clip in enumerate(clips):
        assert seen[i].shape == clip.shape
        np.testing.assert_allclose(seen[i], clip, atol=1.0 / 10000)
        assert np.array_equal(seen[i], ref[i][1])


def test_loader_decode_error(tmp_path, wav_dir):
    d, clips = wav_dir
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    paths = [str(d / "clip0.wav"), str(bad)]
    with pytest.raises(IOError):
        list(AudioLoader(paths, n_threads=1))


def test_scipy_fallback_consistency(wav_dir, monkeypatch):
    """The Python fallback must agree with the native codec."""
    d, clips = wav_dir
    import mfcc_rust_tpu_torch.runtime.wav as wavmod

    native, _ = read_wav(str(d / "clip2.wav"))
    monkeypatch.setattr(wavmod, "load_native", lambda: None)
    fallback, _ = wavmod.read_wav(str(d / "clip2.wav"))
    np.testing.assert_allclose(native, fallback, atol=1e-6)
