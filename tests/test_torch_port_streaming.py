"""The PyTorch port's streaming sessions on the CPU: the streaming STFT,
the carried chunk-GEMM front end, ``StreamingFeatures`` and
``StreamingExtractor``, each fed the same seeded numpy chunks as the JAX
package's classes, and held to the port's own batch functions and to the
float64 oracle ``tests/golden/dfn_ref.py``.  The cases follow
``tests/test_models.py``'s streaming suite one for one, with the JAX class
beside each.

Tolerances: float64 against JAX at rtol 1e-10, atol 1e-12; streamed against
the batch at rtol 1e-10 to 1e-12, atol 1e-12 to 1e-13 (as
``tests/test_models.py``); ``StreamingExtractor`` against the oracle at rtol
1e-9.  float32: max|Δ|/max|ref| <= 5e-3 against JAX (the reference's
float32 gate) and <= 1e-5 against the port's own batch."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu.models import StreamingExtractor as JExtractor
from mfcc_rust_tpu.models import StreamingFeatures as JFeatures
from mfcc_rust_tpu.models import incremental as jinc
from mfcc_rust_tpu.ops import stft as jstft
from tests.golden import dfn_ref

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures
from mfcc_rust_tpu_torch.models import incremental as pinc
from mfcc_rust_tpu_torch.ops import stft as pstft

CPU = {"device": "cpu"}
F64 = {"rtol": 1e-10, "atol": 1e-12}


def port_cfg(cfg):
    return P.from_reference(dataclasses.asdict(cfg))


def sessions(cfg, feature="mfcc"):
    """The JAX session and the port's (on the CPU) for one config."""
    return JFeatures(cfg, feature=feature), StreamingFeatures(port_cfg(cfg), feature=feature,
                                                              **CPU)


def close(ours, ref, **tol):
    """``ours`` (tensor, or the mfe pair) equals ``ref`` in shape and within
    ``tol``."""
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            close(a, b, **tol)
        return
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    ref = np.asarray(ref)
    assert tuple(ours.shape) == ref.shape, (tuple(ours.shape), ref.shape)
    np.testing.assert_allclose(ours.numpy(), ref, **tol)


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def feed_both(jsess, psess, sig, cuts):
    """Feed ``sig[a:b]`` for consecutive cuts to both sessions, hold every
    return of the port to the JAX one, and return the port's outputs
    concatenated."""
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        ours, ref = psess.process(sig[a:b]), jsess.process(sig[a:b])
        close(ours, ref, **F64)
        outs.append(ours)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p) for p in zip(*outs))
    return torch.cat(outs)


def batch(feature, sig, pcfg):
    x = torch.from_numpy(np.asarray(sig))
    if feature == "mel_librosa":
        return PF.mel_spectrogram_librosa(x, pcfg).T
    return getattr(PF, feature)(x, pcfg)


# ------------------------------------------------------ StreamingExtractor --
def test_streaming_session_equals_reference():
    """Chunked session output (warm-up drop and finalize tail) against the
    stateful float64 oracle and the JAX session."""
    cfg = m.vorbis_config(16000, frame_length=0.01).replace(dtype="float64")
    assert cfg.stream_n_pad == 2
    hop = cfg.stream_hop
    sig = np.random.default_rng(0).normal(0, 0.1, hop * 37)
    gold = dfn_ref.mel_spectrogram1(sig, 16000, frame_length=0.01).T
    jsess, psess = JExtractor(cfg), StreamingExtractor(port_cfg(cfg), **CPU)
    outs = []
    for a, b in ((0, 5), (5, 20), (20, 37)):
        ours = psess.process(sig[a * hop:b * hop])
        close(ours, jsess.process(sig[a * hop:b * hop]), **F64)
        outs.append(ours)
    tail = psess.finalize()
    close(tail, jsess.finalize(), rtol=0, atol=0)
    ours = torch.cat(outs + [tail]).numpy()
    assert ours.shape == gold.shape
    np.testing.assert_allclose(ours, gold, rtol=1e-9, atol=1e-15)
    # finalize reset the session: the same stream again gives the same rows
    again = torch.cat([psess.process(sig), psess.finalize()]).numpy()
    np.testing.assert_array_equal(again, ours)


def test_streaming_session_reset():
    cfg = m.vorbis_config(16000).replace(dtype="float64")
    sig = np.random.default_rng(1).normal(0, 0.1, cfg.stream_hop * 10)
    sess = StreamingExtractor(port_cfg(cfg), **CPU)
    a = sess.process(sig)
    sess.reset()
    assert torch.equal(a, sess.process(sig))
    close(a, JExtractor(cfg).process(sig), **F64)


@pytest.mark.parametrize("mel", [True, False], ids=["mel", "power"])
@pytest.mark.parametrize("kw", [{}, {"frame_length": 0.01}, {"fft_points": 1024}],
                         ids=["hop 320", "hop 160, n_pad 2", "fft 1024, n_pad 2"])
def test_extractor_matches_jax_and_batch(kw, mel):
    cfg = m.vorbis_config(16000, **kw).replace(dtype="float64")
    hop = cfg.stream_hop
    sig = np.random.default_rng(2).normal(0, 0.1, hop * 23)
    jsess = JExtractor(cfg, mel=mel)
    psess = StreamingExtractor(port_cfg(cfg), mel=mel, **CPU)
    outs = []
    for a, b in ((0, 1), (1, 2), (2, 9), (9, 23)):
        ours = psess.process(sig[a * hop:b * hop])
        close(ours, jsess.process(sig[a * hop:b * hop]), **F64)
        outs.append(ours)
    outs.append(psess.finalize())
    stream = torch.cat(outs)
    x = torch.from_numpy(sig)
    pcfg = port_cfg(cfg)
    ref = PF.mel_spectrogram(x, pcfg).T if mel else pstft.stft_vorbis_power(x, pcfg)
    close(stream, ref, rtol=1e-10, atol=1e-12)


def test_extractor_rejects_partial_hops_and_keeps_input_dtype():
    cfg = P.vorbis_config(16000)
    sess = StreamingExtractor(cfg, **CPU)
    with pytest.raises(ValueError, match="multiple of hop"):
        sess.process(np.zeros(cfg.stream_hop - 1, np.float32))
    out = sess.process(np.zeros(cfg.stream_hop * 2, np.int16))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 40)
    assert StreamingExtractor(cfg.replace(window="hann"), **CPU).cfg.window == "vorbis"


# ----------------------------------------------------------- streaming STFT --
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["1-D", "batched"])
def test_stft_streaming_matches_jax_scan(lead, dtype):
    """The one-product streaming STFT equals the JAX hop-by-hop scan, and
    chained calls equal one call on the joined signal."""
    cfg = m.vorbis_config(16000, frame_length=0.01).replace(dtype=dtype)
    pcfg = port_cfg(cfg)
    hop = cfg.stream_hop
    sig = np.random.default_rng(3).normal(0, 0.1, lead + (hop * 12,)).astype(dtype)
    jc, jp = jstft.stft_streaming(jnp.asarray(sig), cfg)
    pc, pp = pstft.stft_streaming(torch.from_numpy(sig), pcfg)
    assert tuple(pp.shape) == lead + (12, cfg.freq_size) and pp.dtype == getattr(torch, dtype)
    if dtype == "float64":
        close(pp, jp, **F64)
        close(pc, jc, rtol=0, atol=0)
    else:
        assert rel(pp, jp) <= 1e-5
    carry = pstft.streaming_init(pcfg, lead, torch.float64 if dtype == "float64" else None,
                                 "cpu")
    parts = []
    for a, b in ((0, 1), (1, 5), (5, 12)):
        carry, p = pstft.stft_streaming(torch.from_numpy(sig[..., a * hop:b * hop]), pcfg, carry)
        parts.append(p)
    assert rel(torch.cat(parts, dim=-2), pp) <= (1e-12 if dtype == "float64" else 1e-5)
    assert torch.equal(carry, pc)


def test_streaming_step_matches_jax():
    cfg = m.vorbis_config(16000).replace(dtype="float64")
    pcfg = port_cfg(cfg)
    hop = cfg.stream_hop
    rng = np.random.default_rng(4)
    jc = jstft.streaming_init(cfg)
    pc = pstft.streaming_init(pcfg, device="cpu")
    assert tuple(pc.shape) == (cfg.stream_mem,) and pc.dtype == torch.float64
    chunks, frames = [rng.normal(0, 0.1, hop) for _ in range(4)], []
    for chunk in chunks:
        jc, jp = jstft.streaming_step(jc, jnp.asarray(chunk), cfg)
        pc, pp = pstft.streaming_step(pc, torch.from_numpy(chunk), pcfg)
        close(pp, jp, **F64)
        close(pc, jc, rtol=0, atol=0)
        frames.append(pp)
    # the steps are the frames of one stft_streaming call
    carry, whole = pstft.stft_streaming(torch.from_numpy(np.concatenate(chunks)), pcfg)
    np.testing.assert_allclose(torch.stack(frames).numpy(), whole.numpy(), rtol=1e-12,
                               atol=1e-15)
    assert torch.equal(carry, pc)


def test_stft_streaming_rejects_partial_hop_and_empty_is_empty():
    cfg = P.vorbis_config(16000)
    with pytest.raises(ValueError, match="multiple of hop"):
        pstft.stft_streaming(torch.zeros(cfg.stream_hop + 1), cfg)
    carry = pstft.streaming_init(cfg, device="cpu")
    c2, p = pstft.stft_streaming(torch.zeros(0), cfg, carry)
    assert torch.equal(c2, carry) and tuple(p.shape) == (0, cfg.freq_size)


# ------------------------------------------------------ incremental frontend --
INC = [
    ("mfcc 20/10", m.speechpy_config(16000), "mfcc"),
    ("lmfe 20/10", m.speechpy_config(16000), "lmfe"),
    ("mfe 20/10", m.speechpy_config(16000), "mfe"),
    ("mfcc no dc_elim", m.speechpy_config(16000, dc_elimination=False), "mfcc"),
    ("mfcc hann 30/10", m.speechpy_config(16000, window="hann", frame_length=0.03), "mfcc"),
    ("mel_librosa 2048/512", m.librosa_config(22050), "mel_librosa"),
]


@pytest.mark.parametrize("name,cfg,feature", INC, ids=[c[0] for c in INC])
def test_incremental_feed_rows_match_jax(name, cfg, feature):
    """``feed`` rows, warm-up rows included, for feeds of 1, 3, 64 and 85
    hops (and a sub-hop remainder carried between them)."""
    cfg = cfg.replace(dtype="float64")
    jf = jinc.IncrementalFrontend(cfg, feature)
    pf = pinc.IncrementalFrontend(port_cfg(cfg), feature, **CPU)
    assert isinstance(pf, torch.nn.Module)
    assert (pf.r, pf.P, pf.W, pf.lag) == (jf.r, jf.P, jf.W, jf.lag)
    hop = cfg.frame_step
    rng = np.random.default_rng(5)
    x0 = rng.normal(0, 0.1, hop - 1)
    assert pf.feed(torch.from_numpy(x0)) is None and jf.feed(x0) == []  # no whole chunk
    for hops in (1, 3, 64, 85):
        x = rng.normal(0, 0.1, hops * hop + 7)
        ref = jf.feed(x)
        ours = pf.feed(torch.from_numpy(x))
        if feature == "mfe":
            ref = tuple(np.concatenate([np.asarray(o[i]) for o in ref]) for i in (0, 1))
        else:
            ref = np.concatenate([np.asarray(o) for o in ref])
        close(ours, ref, **F64)
        close(pf.rem, jf.rem, rtol=0, atol=0)
        close(pf.pending, jf.pending, **F64)
        close(pf.pending_e, jf.pending_e, **F64)
    pf.reset()
    assert pf.rem.numel() == 0 and not pf.pending.any() and not pf.pending_e.any()


def test_incremental_buffers_and_refusals():
    cfg = P.speechpy_config(16000)
    fe = pinc.IncrementalFrontend(cfg, "mfe", **CPU)
    names = {n for n, _ in fe.named_buffers()}
    assert names == {"_wcat", "_fb2", "_w2", "_dct"}
    assert tuple(fe._wcat.shape) == (fe.hop, fe.r * fe.W) and fe._wcat.dtype == torch.float32
    assert fe.state_dict() == {}  # constants, rebuilt from the config
    lib = pinc.IncrementalFrontend(P.librosa_config(22050), "mel_librosa", **CPU)
    assert {n for n, _ in lib.named_buffers()} == {"_wcat", "_fb2", "_dct"}  # no energy
    for bad, feature in ((cfg.replace(frame_length=0.025), "mfcc"),
                         (cfg.replace(preemphasis_cof=0.97), "mfcc"), (cfg, "ssc")):
        with pytest.raises(ValueError, match="unsupported"):
            pinc.IncrementalFrontend(bad, feature, **CPU)


SUPPORT = [
    ("speechpy 20/10", m.speechpy_config(16000)),
    ("speechpy 25/10", m.speechpy_config(16000, frame_length=0.025)),
    ("speechpy 10/10", m.speechpy_config(16000, frame_length=0.01)),
    ("speechpy stride 12 ms", m.speechpy_config(16000, frame_stride=0.012)),
    ("speechpy preemph", m.speechpy_config(16000, preemphasis_cof=0.97)),
    ("speechpy fft 2048", m.speechpy_config(16000, fft_points=2048)),
    ("speechpy 5/1 ms, r > 8", m.speechpy_config(16000, frame_length=0.01,
                                                 frame_stride=0.001)),
    ("librosa 22050", m.librosa_config(22050)),
    ("librosa 16k 512/160", m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)),
    ("librosa win 1024", m.librosa_config(22050, win_length=1024)),
    ("librosa frame 1024", m.librosa_config(22050).replace(frame_length_samples=1024)),
]


@pytest.mark.parametrize("feature", ["mfcc", "lmfe", "mfe", "mel_librosa", "ssc"])
@pytest.mark.parametrize("name,cfg", SUPPORT, ids=[c[0] for c in SUPPORT])
def test_incremental_supported_matches_jax(name, cfg, feature):
    assert pinc.incremental_supported(port_cfg(cfg), feature) == \
        jinc.incremental_supported(cfg, feature), (name, feature)


# ------------------------------------------------------- StreamingFeatures --
class TestStreamingFeatures:
    def test_streaming_mfcc_equals_batch(self):
        cfg = m.speechpy_config(16000).replace(dtype="float64")
        sig = np.random.default_rng(10).normal(0, 0.1, 16000)
        jsess, psess = sessions(cfg)
        # ragged chunk sizes incl. ones smaller than a frame
        cuts = [0, 100, 413, 1000, 5000, 5003, 12000, 16000]
        stream = feed_both(jsess, psess, sig, cuts)
        close(stream, batch("mfcc", sig, port_cfg(cfg)), rtol=1e-12, atol=1e-13)

    def test_streaming_lmfe_and_mfe(self):
        cfg = m.speechpy_config(16000).replace(dtype="float64")
        pcfg = port_cfg(cfg)
        sig = np.random.default_rng(11).normal(0, 0.1, 8000)
        out = feed_both(*sessions(cfg, "lmfe"), sig, [0, 3000, 8000])
        close(out, batch("lmfe", sig, pcfg), rtol=1e-12, atol=1e-13)
        out = feed_both(*sessions(cfg, "mfe"), sig, [0, 4096, 8000])
        close(out, batch("mfe", sig, pcfg), rtol=1e-12, atol=1e-13)

    def test_short_feed_emits_nothing_then_resumes(self):
        jsess, psess = sessions(m.speechpy_config(16000))
        empty = psess.process(np.zeros(100, np.float32))
        assert tuple(empty.shape) == (0, 13) == jsess.process(np.zeros(100, np.float32)).shape
        assert empty.dtype == torch.float32
        x = np.random.default_rng(12).normal(0, 0.1, 2000).astype(np.float32)
        out = psess.process(x)
        assert out.shape[0] == (2100 - 320) // 160
        assert rel(out, jsess.process(x)) <= 5e-3

    @pytest.mark.parametrize("cfg,feature", [
        (m.speechpy_config(16000), "mfcc"), (m.speechpy_config(16000), "mfe"),
        (m.speechpy_config(16000, frame_length=0.025), "mfcc"),
        (m.speechpy_config(16000, frame_length=0.025), "mfe"),
        (m.librosa_config(16000, n_fft=512, hop_length=128, n_mels=80), "mel_librosa"),
        (m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80), "mel_librosa"),
    ], ids=["mfcc carried", "mfe carried", "mfcc recompute", "mfe recompute",
            "mel carried", "mel recompute"])
    def test_empty_returns(self, cfg, feature):
        jsess, psess = sessions(cfg, feature)
        ours, ref = psess.process(np.zeros(10, np.float32)), jsess.process(
            np.zeros(10, np.float32))
        if feature == "mfe":
            assert [tuple(t.shape) for t in ours] == [r.shape for r in ref] == [(0, 40), (0,)]
        else:
            assert tuple(ours.shape) == ref.shape == (0, 13 if feature == "mfcc" else 80)

    def test_rejects_unknown_feature(self):
        for cls, kw in ((JFeatures, {}), (StreamingFeatures, CPU)):
            with pytest.raises(ValueError, match="unsupported streaming feature"):
                cls(m.speechpy_config(16000) if cls is JFeatures else P.speechpy_config(16000),
                    feature="ssc", **kw)

    def test_rejects_preemphasis(self):
        for cls, cfg, kw in ((JFeatures, m.speechpy_config(16000, preemphasis_cof=0.97), {}),
                             (StreamingFeatures, P.speechpy_config(16000, preemphasis_cof=0.97),
                              CPU)):
            for feature in ("mfcc", "mel_librosa"):
                c = cfg if feature == "mfcc" else cfg.replace(
                    frame_length_samples=512, fft_points=512)
                with pytest.raises(ValueError, match="preemphasis"):
                    cls(c, feature=feature, **kw)

    def test_streaming_librosa_mel_equals_batch(self):
        cfg = m.librosa_config(22050).replace(dtype="float64", center=False)
        sig = np.random.default_rng(13).normal(0, 0.1, 44100)
        jsess, psess = sessions(cfg, "mel_librosa")
        assert psess.cfg.center is False and psess._inc is not None
        # ragged chunks, incl. sub-frame ones (librosa.stream-style blocks)
        cuts = [0, 500, 2048, 2100, 9000, 22050, 22051, 40000, 44100]
        stream = feed_both(jsess, psess, sig, cuts)
        ref = batch("mel_librosa", sig, port_cfg(cfg))
        close(stream, ref, rtol=1e-10, atol=1e-12)
        # reset gives a fresh, identical session
        psess.reset()
        again = torch.cat([psess.process(sig[:22050]), psess.process(sig[22050:])])
        close(again, ref, rtol=1e-10, atol=1e-12)

    def test_streaming_librosa_mel_hop_misaligned(self):
        """16 kHz 512/160: the recompute path, batch-equal."""
        cfg = m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80
                               ).replace(dtype="float64", center=False)
        sig = np.random.default_rng(14).normal(0, 0.1, 24000)
        jsess, psess = sessions(cfg, "mel_librosa")
        assert psess._inc is None and jsess._inc is None
        cuts = [0, 160, 512, 700, 9000, 16000, 24000]
        stream = feed_both(jsess, psess, sig, cuts)
        close(stream, batch("mel_librosa", sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    def test_streaming_librosa_mel_frame_size_neq_fft(self):
        bad = m.librosa_config(22050).replace(frame_length_samples=1024)
        with pytest.raises(ValueError, match="frame_size == fft_points"):
            JFeatures(bad, feature="mel_librosa")
        with pytest.raises(ValueError, match="frame_size == fft_points"):
            StreamingFeatures(port_cfg(bad), feature="mel_librosa", **CPU)
        with pytest.raises(ValueError, match="frames by fft_points"):
            PF.mel_spectrogram_librosa(torch.zeros(4096), port_cfg(bad))

    def test_streaming_librosa_mel_short_window(self):
        """win_length < n_fft streams batch-equal."""
        cfg = m.librosa_config(22050, win_length=1024).replace(dtype="float64", center=False)
        sig = np.random.default_rng(15).normal(0, 0.1, 44100)
        stream = feed_both(*sessions(cfg, "mel_librosa"), sig, [0, 1500, 2100, 30000, 44100])
        close(stream, batch("mel_librosa", sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    @pytest.mark.parametrize("feature", ["mfcc", "lmfe"])
    def test_incremental_engaged_and_hop_chunks_equal_batch(self, feature):
        """The carried front end serves one-hop (real-time) chunks, batch-equal."""
        cfg = m.speechpy_config(16000).replace(dtype="float64")
        sig = np.random.default_rng(16).normal(0, 0.1, 16000)
        jsess, psess = sessions(cfg, feature)
        assert psess._inc is not None and jsess._inc is not None
        stream = feed_both(jsess, psess, sig, list(range(0, 16001, cfg.frame_step)))
        close(stream, batch(feature, sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    def test_incremental_fallback_hop_misaligned_ragged(self):
        """25 ms / 10 ms (400/160): the recompute path under ragged sub-hop
        and multi-hop feeds."""
        cfg = m.speechpy_config(16000).replace(dtype="float64", frame_length=0.025)
        jsess, psess = sessions(cfg)
        assert psess._inc is None and jsess._inc is None
        sig = np.random.default_rng(17).normal(0, 0.1, 16000)
        cuts = [0, 160, 400, 431, 512, 700, 4000, 9000, 9100, 16000]
        stream = feed_both(jsess, psess, sig, cuts)
        close(stream, batch("mfcc", sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    def test_incremental_fallback_still_works(self):
        cfg = m.speechpy_config(16000).replace(dtype="float64", frame_stride=0.012)
        jsess, psess = sessions(cfg)
        assert psess._inc is None
        sig = np.random.default_rng(18).normal(0, 0.1, 8000)
        stream = feed_both(jsess, psess, sig, [0, 5000, 8000])
        close(stream, batch("mfcc", sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    def test_incremental_mfe_ragged_chunks(self):
        cfg = m.speechpy_config(16000).replace(dtype="float64")
        jsess, psess = sessions(cfg, "mfe")
        assert psess._inc is not None
        sig = np.random.default_rng(19).normal(0, 0.1, 12000)
        cuts = [0, 7, 160, 481, 3000, 3001, 9999, 12000]
        stream = feed_both(jsess, psess, sig, cuts)
        close(stream, batch("mfe", sig, port_cfg(cfg)), rtol=1e-10, atol=1e-12)

    def test_streaming_librosa_default_config_forces_uncentered(self):
        sess = StreamingFeatures(sample_rate=22050, feature="mel_librosa", **CPU)
        assert sess.cfg.center is False and sess.cfg.window == "hann"
        assert tuple(sess.process(np.zeros(2047, np.float32)).shape) == (0, 128)
        assert tuple(sess.process(np.zeros(1, np.float32)).shape) == (1, 128)

    @pytest.mark.parametrize("name,cfg", [SUPPORT[i] for i in (0, 1, 2, 3, 5, 6, 7, 8, 9)],
                             ids=[SUPPORT[i][0] for i in (0, 1, 2, 3, 5, 6, 7, 8, 9)])
    def test_path_choice_matches_jax(self, name, cfg):
        feature = "mel_librosa" if cfg.fbank_style == "librosa" else "mfcc"
        jsess, psess = sessions(cfg, feature)
        assert (psess._inc is None) == (jsess._inc is None), name
        assert psess.cfg == port_cfg(jsess.cfg)

    def test_reset_reproduces_a_session_exactly(self):
        for cfg, feature in ((m.speechpy_config(16000), "mfe"),
                             (m.speechpy_config(16000, frame_length=0.025), "mfcc")):
            sess = StreamingFeatures(port_cfg(cfg), feature=feature, **CPU)
            sig = np.random.default_rng(20).normal(0, 0.1, 6000).astype(np.float32)
            cuts = [0, 7, 1000, 1001, 4321, 6000]
            first = [sess.process(sig[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
            sess.reset()
            for (a, b), f in zip(zip(cuts[:-1], cuts[1:]), first):
                again = sess.process(sig[a:b])
                pairs = zip(again, f) if feature == "mfe" else [(again, f)]
                assert all(torch.equal(u, v) for u, v in pairs)

    def test_takes_tensors_and_int16(self):
        cfg = P.speechpy_config(16000)
        sess = StreamingFeatures(cfg, **CPU)
        x = (np.random.default_rng(21).normal(0, 0.1, 4000) * 3e4).astype(np.int16)
        a = torch.cat([sess.process(torch.from_numpy(x[:1000])), sess.process(x[1000:])])
        assert a.dtype == torch.float32
        assert rel(a, PF.mfcc(torch.from_numpy(x).float(), cfg)) <= 1e-5


# ----------------------------------------------------------------- float32 --
F32 = [
    ("mfcc 20/10, carried", m.speechpy_config(16000), "mfcc", 160),
    ("mfe 20/10, carried", m.speechpy_config(16000), "mfe", 1000),
    ("mfcc 25/10, recompute", m.speechpy_config(16000, frame_length=0.025), "mfcc", 1600),
    ("mel 2048/512, carried", m.librosa_config(22050), "mel_librosa", 2048),
    ("mel 512/160, recompute", m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
     "mel_librosa", 1600),
]


@pytest.mark.parametrize("name,cfg,feature,size", F32, ids=[c[0] for c in F32])
def test_float32_sessions(name, cfg, feature, size):
    """float32 sessions against JAX at the reference's 5e-3 gate and against
    the port's own batch at 1e-5."""
    sig = np.random.default_rng(22).normal(0, 0.1, 16000).astype(np.float32)
    jsess, psess = sessions(cfg, feature)
    cuts = list(range(0, sig.size, size)) + [sig.size]
    outs, refs = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        outs.append(psess.process(sig[a:b]))
        refs.append(jsess.process(sig[a:b]))
    if feature == "mfe":
        stream = tuple(torch.cat(p) for p in zip(*outs))
        ref = tuple(np.concatenate(p) for p in zip(*refs))
    else:
        stream, ref = torch.cat(outs), np.concatenate(refs)
    pairs = list(zip(stream, ref)) if feature == "mfe" else [(stream, ref)]
    own = batch(feature, sig, psess.cfg)
    own_pairs = list(zip(stream, own)) if feature == "mfe" else [(stream, own)]
    for (s, r), (_, o) in zip(pairs, own_pairs):
        assert s.dtype == torch.float32
        assert rel(s, r) <= 5e-3, name
        assert rel(s, o) <= 1e-5, name
