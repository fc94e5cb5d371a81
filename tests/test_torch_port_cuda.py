"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the reference's
tests.)  Tolerance 1e-4 in max|Δ|/max|ref|: the MFCC kernel runs an FFT
where its plain version multiplies by a DFT matrix, and the log of a small
band energy turns that rounding into its relative error; the CT mel kernel
factors the FFT otherwise than its plain version.  ``mfcc_librosa`` is held
at rtol 1e-3, atol 1e-4, the reference's own tolerance for its kernel."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as pk

CONFIGS = [
    ("default 20/10", {}, (2, 8000)),
    ("25/10 r=3", {"frame_length": 0.025}, (2, 8000)),
    ("preemph 0.97", {"preemphasis_cof": 0.97}, (2, 8000)),
    ("no dc_elim", {"dc_elimination": False}, (2, 8000)),
    ("r=1 10/10", {"frame_length": 0.01}, (2, 8000)),
    ("batched 3-D", {}, (2, 2, 4000)),
    ("T < fl", {}, (300,)),
    ("128 mels", {"num_filters": 128, "num_cepstral": 40}, (2, 8000)),
    ("fft 1024, two passes", {"fft_points": 1024}, (2, 8000)),
    ("fft 400, path 2", {"fft_points": 400, "frame_length": 0.025}, (2, 8000)),
    ("fft 256", {"fft_points": 256, "frame_length": 0.016}, (2, 8000)),
    ("T no multiple of 4 or hop", {}, (3, 8001)),
    ("headline", {}, (48, 177664)),
]


def rel(a, ref):
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.numel() == 0:
        return 0.0
    return ((a - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_kernel_matches_plain_on_card(cuda_device, name, kw, shape):
    cfg = P.speechpy_config(16000, **kw)
    x = torch.from_numpy(np.random.default_rng(14).normal(0, 0.1, shape).astype(np.float32))
    xd = x.to(cuda_device)
    before = pk.mfcc_fused.launches
    out = PF.mfcc(xd, cfg)
    torch.cuda.synchronize()
    assert pk.mfcc_fused.launches == before + (1 if out.shape[-2] else 0)
    xp = xd if not cfg.preemphasis_cof else PF._framing.preemphasis(xd, 1, cfg.preemphasis_cof)
    assert rel(pk.mfcc_fused(xp, cfg), pk.mfcc_fused_plain(xp, cfg)) <= 1e-4, name
    if name == "headline":
        # the chunk-GEMM path takes the DC bin from a float32 product: among
        # 53k random frames some X_0 nearly cancels, and that path then sits
        # 2e-4 to 6e-4 off a float64 computation (PERF.md), where the kernel
        # and its plain version sum X_0 in float64
        return
    assert rel(out, PF.mfcc(xd, cfg.replace(pallas="off"))) <= 1e-4, name
    assert rel(out, PF.mfcc(x, cfg.replace(pallas="off"))) <= 1e-4, name


@pytest.mark.cuda
def test_kernel_grad_matches_plain_on_card(cuda_device):
    cfg = P.speechpy_config(16000)
    x = torch.from_numpy(np.random.default_rng(15).normal(0, 0.1, (2, 8000)).astype(np.float32))
    a = x.to(cuda_device).requires_grad_(True)
    PF.mfcc(a, cfg).sum().backward()
    b = x.to(cuda_device).requires_grad_(True)
    PF.mfcc(b, cfg.replace(pallas="off")).sum().backward()
    assert rel(a.grad, b.grad) <= 1e-4


@pytest.mark.cuda
def test_wrapper_refuses_float64_on_card(cuda_device):
    with pytest.raises(TypeError):
        pk.mfcc_fused(torch.zeros(4000, dtype=torch.float64, device=cuda_device),
                      P.speechpy_config(16000))


# (name, librosa_config args, kwargs, input shape)
LIBROSA = [
    ("2048/512", (22050,), {}, (2, 22050)),
    ("1024/256", (16000,), dict(n_fft=1024, hop_length=256), (2, 16000)),
    ("512/160/80", (16000,), dict(n_fft=512, hop_length=160, n_mels=80), (2, 16000)),
    ("512/130/64", (16000,), dict(n_fft=512, hop_length=130, n_mels=64), (2, 16000)),
    ("2048/768", (16000,), dict(n_fft=2048, hop_length=768), (2, 16000)),
    ("2048/100", (22050,), dict(hop_length=100), (2, 16000)),
    ("uncentred", (22050,), dict(center=False), (2, 16000)),
    ("1-D", (22050,), {}, (16000,)),
    ("3-D", (22050,), {}, (2, 2, 8000)),
    ("100 samples, centred", (22050,), {}, (100,)),
    ("100 samples, uncentred", (22050,), dict(center=False), (100,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,args,kw,shape", LIBROSA, ids=[c[0] for c in LIBROSA])
def test_ct_mel_kernel_matches_plain_on_card(cuda_device, name, args, kw, shape):
    kw = dict(kw)
    center = kw.pop("center", True)
    cfg = P.librosa_config(*args, **kw).replace(center=center)
    x = torch.from_numpy(np.random.default_rng(16).normal(0, 0.1, shape).astype(np.float32))
    xd = x.to(cuda_device)
    before = ck.ct_mel.launches
    out = PF.mel_spectrogram_librosa(xd, cfg)
    torch.cuda.synchronize()
    assert out.is_cuda
    assert ck.ct_mel.launches == before + (1 if out.shape[-1] else 0)
    assert rel(out, PF.mel_spectrogram_librosa(xd, cfg.replace(pallas="off"))) <= 1e-4, name
    assert rel(out, PF.mel_spectrogram_librosa(x, cfg)) <= 1e-4, name
    assert rel(ck.ct_mel(xd, cfg), ck.ct_mel_plain(xd, cfg)) <= 1e-4, name
    if name == "100 samples, centred":
        assert out.shape == (128, 1)
    if name == "100 samples, uncentred":
        assert out.shape == (128, 0)


@pytest.mark.cuda
def test_librosa_heads_go_through_the_kernel_on_card(cuda_device):
    cfg = P.librosa_config()
    x = torch.from_numpy(np.random.default_rng(17).normal(0, 0.1, (2, 22050)).astype(np.float32))
    xd = x.to(cuda_device)
    before = ck.ct_mel.launches
    mf = PF.mfcc_librosa(xd, cfg)
    lm = PF.log_mel_spectrogram(xd, cfg)
    torch.cuda.synchronize()
    assert ck.ct_mel.launches == before + 2
    off = cfg.replace(pallas="off")
    np.testing.assert_allclose(mf.cpu().numpy(), PF.mfcc_librosa(xd, off).cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(lm.cpu().numpy(), PF.log_mel_spectrogram(xd, off).cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    api = P.mel_spectrogram_librosa(x.numpy())
    assert api.is_cuda and api.shape == (2, 128, 44)
    assert ck.ct_mel.launches == before + 3


@pytest.mark.cuda
def test_ct_mel_grad_matches_plain_on_card(cuda_device):
    cfg = P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)
    x = torch.from_numpy(np.random.default_rng(18).normal(0, 0.1, (2, 8000)).astype(np.float32))
    a = x.to(cuda_device).requires_grad_(True)
    PF.mel_spectrogram_librosa(a, cfg).sqrt().sum().backward()
    b = x.to(cuda_device).requires_grad_(True)
    PF.mel_spectrogram_librosa(b, cfg.replace(pallas="off")).sqrt().sum().backward()
    assert rel(a.grad, b.grad) <= 1e-4


@pytest.mark.cuda
def test_ct_mel_wrapper_refuses_float64_on_card(cuda_device):
    with pytest.raises(TypeError):
        ck.ct_mel(torch.zeros(4000, dtype=torch.float64, device=cuda_device), P.librosa_config())


# (name, librosa_config args, kwargs, input shape, the kernel's path):
# path 1 (register FFT, n/2 a power of two to 1024) at the librosa headline
# and the sizes and hops around it, path 2 (Stockham stages) elsewhere
K2_PATHS = [
    ("2048/512 headline", (22050,), {}, (32, 220500), 1),
    ("1024/256", (16000,), dict(n_fft=1024, hop_length=256), (2, 16000), 1),
    ("512/160/80", (16000,), dict(n_fft=512, hop_length=160, n_mels=80), (2, 16000), 1),
    ("256/64", (8000,), dict(n_fft=256, n_mels=40), (2, 8000), 1),
    ("2048/100", (22050,), dict(hop_length=100), (2, 16000), 1),
    ("2048/333 odd hop", (22050,), dict(hop_length=333), (2, 16001), 1),
    ("768/192", (16000,), dict(n_fft=768, n_mels=64), (2, 16000), 2),
    ("1280/320", (16000,), dict(n_fft=1280), (2, 16000), 2),
    ("4096/1024", (44100,), dict(n_fft=4096), (2, 30000), 2),
    ("T not a multiple of 4", (22050,), {}, (3, 16003), 1),
    ("1-D", (22050,), {}, (16001,), 1),
    ("3-D", (22050,), {}, (2, 3, 8000), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,args,kw,shape,path", K2_PATHS, ids=[c[0] for c in K2_PATHS])
def test_ct_mel_paths_on_card(cuda_device, name, args, kw, shape, path):
    cfg = P.librosa_config(*args, **kw)
    x = np.random.default_rng(19).normal(0, 0.1, shape).astype(np.float32)
    if name.endswith("headline"):  # the main path's bucketed, centre-padded batch
        xd, cfg, _ = PA._prep_librosa(x, cfg, True, None)
    else:
        xd = torch.from_numpy(x).to(cuda_device)
    t = xd.shape[-1] + (cfg.fft_points if cfg.center else 0)
    frames = 1 + (t - cfg.fft_points) // cfg.frame_step
    assert ck.path_for(cfg) == path, name
    plan = ck.launch_plan(cfg, int(np.prod(xd.shape[:-1])), frames)
    assert plan["path"] == path and plan["grid"] >= 1, (name, plan)
    before = ck.ct_mel.launches
    out = ck.ct_mel(xd, cfg)
    torch.cuda.synchronize()
    assert ck.ct_mel.launches == before + 1, name
    assert out.shape == xd.shape[:-1] + (frames, cfg.num_filters)
    assert rel(out, ck.ct_mel_plain(xd, cfg)) <= 1e-4, name


@pytest.mark.cuda
def test_ct_mel_grad_through_path1_at_2048_on_card(cuda_device):
    cfg = P.librosa_config(22050)
    x = torch.from_numpy(np.random.default_rng(20).normal(0, 0.1, (2, 22050)).astype(np.float32))
    a = x.to(cuda_device).requires_grad_(True)
    before = ck.ct_mel.launches
    PF.mel_spectrogram_librosa(a, cfg).sqrt().sum().backward()
    assert ck.ct_mel.launches == before + 1
    b = x.to(cuda_device).requires_grad_(True)
    PF.mel_spectrogram_librosa(b, cfg.replace(pallas="off")).sqrt().sum().backward()
    assert rel(a.grad, b.grad) <= 1e-4


# The entry points without a kernel of their own (their products run on
# cuBLAS): each on the card against the same call on the CPU, float32, at
# max|Δ|/max|ref| <= 1e-5 (3e-5 for the log heads, as the CPU tests hold
# them against JAX).
HEADS = ("mfcc", "lmfe", "mfe", "ssc", "energy")
NEW_CALLS = [
    ("ssc", "signal", (16000,), {}),
    ("extract", "signal", (16000,), {"which": HEADS}),
    ("mel_spectrogram", "signal", (16000,), {}),
    ("mel_spectrogram", "signal", (16000,), {"frame_length": 0.008}),
    ("preemphasis", "signal", (), {}),
    ("stack_frames", "signal", (16000,), {}),
    ("resample", "signal", (16000, 44100), {}),
    ("resample_poly", "signal", (160, 441), {}),
    ("derivative_extraction", "feats", (), {}),
    ("extract_derivative_feature", "feats", (), {}),
    ("delta", "feats", (), {}),
    ("delta_librosa", "feats", (), {"axis": -2}),
    ("cmvn", "feats", (True,), {}),
    ("cmvnw", "feats", (301, True), {}),
    ("log_power_spectrum", "frames", (), {}),
]


def _flat(out):
    """A result as a flat dict of tensors: a dict's heads, a pair's halves."""
    if not isinstance(out, dict):
        out = {"": out}
    return {f"{k}{i}": t for k, v in out.items()
            for i, t in enumerate(v if isinstance(v, tuple) else (v,))}


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,args,kw", NEW_CALLS,
                         ids=[f"{c[0]} {c[3]}" for c in NEW_CALLS])
def test_new_entry_points_on_card_match_cpu(cuda_device, name, kind, args, kw):
    rng = np.random.default_rng(21)
    x = {"signal": rng.normal(0, 0.1, (2, 8000)),
         "feats": rng.normal(1.0, 2.0, (2, 60, 13)),
         "frames": rng.normal(0, 0.1, (40, 400))}[kind].astype(np.float32)
    fn = getattr(P, name)
    before = pk.mfcc_fused.launches, ck.ct_mel.launches
    got = _flat(fn(x, *args, **kw))
    ref = _flat(fn(x, *args, **kw, device="cpu"))
    torch.cuda.synchronize()
    assert (pk.mfcc_fused.launches, ck.ct_mel.launches) == before, "no kernel on this path"
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].is_cuda and got[k].dtype == torch.float32, (name, k)
        tol = 3e-5 if k.startswith(("lmfe", "mfcc")) else 1e-5
        assert rel(got[k], ref[k]) <= tol, (name, k)


@pytest.mark.cuda
def test_feature_extractor_and_transforms_launch_the_kernels_on_card(cuda_device):
    from mfcc_rust_tpu_torch import transforms as T

    x = torch.from_numpy(np.random.default_rng(22).normal(0, 0.1, (2, 16000))
                         .astype(np.float32)).to(cuda_device)
    fe = P.FeatureExtractor(device="cuda")
    assert all(b.is_cuda for b in fe.buffers())
    k1, k2 = pk.mfcc_fused.launches, ck.ct_mel.launches
    out = fe(x)
    torch.cuda.synchronize()
    assert (pk.mfcc_fused.launches - k1, ck.ct_mel.launches - k2) == (1, 0)
    assert rel(out, PF.mfcc(x.cpu(), fe.cfg)) <= 1e-4  # the kernel against the plain path
    k1 = pk.mfcc_fused.launches
    sp_out = T.SpeechpyMFCC(16000)(x)
    assert pk.mfcc_fused.launches == k1 + 1 and sp_out.is_cuda
    assert rel(sp_out, P.mfcc(x.cpu(), 16000, device="cpu")) <= 1e-4
    k2 = ck.ct_mel.launches
    mel = T.MelSpectrogram(sr=16000, n_fft=512, hop_length=160, n_mels=80)(x)
    mf = T.MFCC(sr=16000)(x)
    torch.cuda.synchronize()
    assert ck.ct_mel.launches == k2 + 2 and mel.is_cuda and mf.is_cuda
    assert rel(mel, P.mel_spectrogram_librosa(x.cpu(), 16000, n_fft=512, hop_length=160,
                                              n_mels=80, device="cpu")) <= 1e-4
    # gradients flow through the kernels' backward passes
    xg = x.clone().requires_grad_(True)
    k1, k2 = pk.mfcc_fused.launches, ck.ct_mel.launches
    (T.SpeechpyMFCC(16000)(xg).sum() + T.MelSpectrogram(sr=16000)(xg).sqrt().sum()).backward()
    assert (pk.mfcc_fused.launches - k1, ck.ct_mel.launches - k2) == (1, 1)
    assert bool(torch.isfinite(xg.grad).all())


# Streaming sessions: (name, config, feature, chunk samples, path).  On the
# card each against the same session on the CPU, float32, within 1e-4: the
# recompute sessions run K1 or K2 where the CPU runs the plain path, and the
# carried ones round their one-row products on cuBLAS otherwise than the
# CPU (the log of the DC-only first band turns that into its relative error).
STREAMING = [
    ("mfcc carried", P.speechpy_config(16000), "mfcc", 160, "incremental"),
    ("mfe carried, ragged", P.speechpy_config(16000), "mfe", 0, "incremental"),
    ("mfcc 25/10 recompute", P.speechpy_config(16000, frame_length=0.025), "mfcc", 1600,
     "recompute"),
    ("mel 2048/512 carried", P.librosa_config(22050), "mel_librosa", 2048, "incremental"),
    ("mel 512/160 recompute", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
     "mel_librosa", 1600, "recompute"),
    ("extractor", P.vorbis_config(16000), "stft", 3200, "stft"),
]


def _session(cfg, feature, device):
    from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures

    if feature == "stft":
        return StreamingExtractor(cfg, device=device)
    return StreamingFeatures(cfg, feature=feature, device=device)


def _feed(sess, chunks):
    """(the outputs concatenated, as a list of tensors; calls that emitted)."""
    outs = [sess.process(c) for c in chunks]
    rows = [(o[0] if isinstance(o, tuple) else o).shape[0] for o in outs]
    parts = zip(*outs) if isinstance(outs[0], tuple) else [outs]
    return [torch.cat(p) for p in parts], sum(r > 0 for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,feature,size,path", STREAMING, ids=[c[0] for c in STREAMING])
def test_streaming_session_on_card_matches_cpu(cuda_device, name, cfg, feature, size, path):
    rng = np.random.default_rng(23)
    x = rng.normal(0, 0.1, 32000).astype(np.float32)
    sizes = rng.integers(1, 4001, 40) if size == 0 else [size] * (x.size // size)
    ends = np.cumsum(sizes)
    chunks = [x[e - n:e] for n, e in zip(sizes, ends) if e <= x.size]
    card, cpu = _session(cfg, feature, cuda_device), _session(cfg, feature, "cpu")
    if path != "stft":
        assert (card._inc is None) == (path == "recompute")
    before = pk.mfcc_fused.launches, ck.ct_mel.launches
    got, emitting = _feed(card, chunks)
    torch.cuda.synchronize()
    launched = (pk.mfcc_fused.launches - before[0], ck.ct_mel.launches - before[1])
    want = {("recompute", "mfcc"): (emitting, 0), ("recompute", "mel_librosa"): (0, emitting)}
    assert emitting > 0 and launched == want.get((path, feature), (0, 0)), (name, launched)
    ref, _ = _feed(cpu, chunks)
    for g, r in zip(got, ref):
        assert g.is_cuda and g.dtype == torch.float32
        assert rel(g, r) <= 1e-4, name


@pytest.mark.cuda
def test_streaming_launch_counts_on_card(cuda_device):
    """A recompute call launches its kernel only when it emits frames; the
    carried sessions and the streaming STFT never launch one."""
    from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures

    x = np.random.default_rng(24).normal(0, 0.1, 8000).astype(np.float32)
    k1 = StreamingFeatures(P.speechpy_config(16000, frame_length=0.025), device=cuda_device)
    k2 = StreamingFeatures(P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
                           feature="mel_librosa", device=cuda_device)
    # (samples fed, frames emitted): speechpy counts floor((L - 400)/160),
    # librosa 1 + (L - 512)//160
    for sess, counter, feeds in (
            (k1, pk.mfcc_fused, ((100, 0), (300, 0), (160, 1), (159, 0), (1, 1), (4000, 25))),
            (k2, ck.ct_mel, ((100, 0), (300, 0), (112, 1), (159, 0), (1, 1), (4000, 25)))):
        for n, frames in feeds:
            before = counter.launches
            out = sess.process(x[:n])
            assert out.shape[0] == frames and counter.launches == before + (frames > 0)
    before = pk.mfcc_fused.launches, ck.ct_mel.launches
    for sess in (StreamingFeatures(device=cuda_device),
                 StreamingFeatures(P.librosa_config(22050), feature="mel_librosa",
                                   device=cuda_device)):
        assert sess._inc is not None
        for n in (100, 2048, 4000):
            sess.process(x[:n])
    ex = StreamingExtractor(device=cuda_device)
    ex.process(x[:6400])
    ex.finalize()
    torch.cuda.synchronize()
    assert (pk.mfcc_fused.launches, ck.ct_mel.launches) == before


# ------------------------------------------------------------ corpus path --
def _corpus_batch(seed: int = 30, b: int = 4, t: int = 160 * 200):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 777, t - 3200, 160 * 90][:b], dtype=np.int64)
    clips = [(np.rint(rng.normal(0, 0.1, n) * 32768).clip(-32768, 32767) / 32768).astype(
        np.float32) for n in lengths]
    return clips, lengths, t


@pytest.mark.cuda
def test_extraction_step_on_card_matches_cpu(cuda_device):
    """The one-rank step on the card against the same step on the CPU:
    mfcc (K1, one launch a batch, against the CPU's chunk-GEMM: the float32
    DC bin, PERF.md §7) within 5e-3; the plain heads within 1e-5, the log
    ones (lmfe, the multi-feature mfcc) within 1e-4, the gate of two
    float32 forms of one product, whose first log band moves where the DC
    bin nearly cancels; the multi-feature batch launches no kernel."""
    from mfcc_rust_tpu_torch.parallel import (extraction_step_packed, frame_counts_host,
                                              make_mesh, pack_signals)

    clips, lengths, t = _corpus_batch()
    cfg = P.speechpy_config(16000)
    vcfg = P.vorbis_config(16000, frame_length=0.01)
    gpu, cpu = make_mesh(device=cuda_device), make_mesh(device="cpu")
    flat, offs, lens = pack_signals(clips, 4, pcm16_exact=True)
    for feature, c, k1 in (("mfcc", cfg, 1), ("lmfe", cfg, 0), ("mfe", cfg, 0),
                           ("melspec", vcfg, 0), (("mfcc", "lmfe", "mfe", "ssc", "energy"), cfg, 0)):
        counts = frame_counts_host(lens, c, feature if isinstance(feature, str) else "mfcc")
        before = pk.mfcc_fused.launches
        got, gm = extraction_step_packed(flat, offs, lens, t, c, gpu, feature,
                                         frame_counts=counts)
        torch.cuda.synchronize()
        assert pk.mfcc_fused.launches - before == k1, feature
        ref, rm = extraction_step_packed(flat, offs, lens, t, c, cpu, feature,
                                         frame_counts=counts)
        if isinstance(feature, str):
            got, ref, gm, rm = {feature: got}, {feature: ref}, {feature: gm}, {feature: rm}
        for h in got:
            g = got[h][0] if h == "mfe" else got[h]
            r = ref[h][0] if h == "mfe" else ref[h]
            tol = 5e-3 if k1 else 1e-4 if h in ("mfcc", "lmfe") else 1e-5
            assert g.is_cuda and rel(g, r) <= tol, (feature, h)
            assert float(gm[h].count) == float(rm[h].count)


@pytest.mark.cuda
def test_runner_on_card_matches_cpu(cuda_device, tmp_path):
    """The corpus runner on the card writes the files the CPU runner writes,
    within 5e-3 (K1 against the chunk-GEMM), one K1 launch per batch."""
    from mfcc_rust_tpu_torch.parallel import make_mesh
    from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
    from mfcc_rust_tpu_torch.runtime import write_wav

    rng = np.random.default_rng(31)
    paths = []
    for i in range(9):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), rng.normal(0, 0.1, 8000 + 1500 * i).astype(np.float32), 16000)
        paths.append(str(p))
    before = pk.mfcc_fused.launches
    runner = CorpusRunner(paths, P.speechpy_config(16000), make_mesh(device=cuda_device),
                          batch_size=4, out_dir=str(tmp_path / "gpu"))
    mg = runner.run()
    assert pk.mfcc_fused.launches - before == runner.meter.counters["dispatches"]
    mc = CorpusRunner(paths, P.speechpy_config(16000), make_mesh(device="cpu"), batch_size=4,
                      out_dir=str(tmp_path / "cpu")).run()
    for i in range(9):
        a, b = np.load(tmp_path / "gpu" / f"u{i}.npy"), np.load(tmp_path / "cpu" / f"u{i}.npy")
        assert rel(torch.from_numpy(a), torch.from_numpy(b)) <= 5e-3, i
    assert int(mg.count) == int(mc.count)


@pytest.mark.cuda
def test_nccl_world_one_equals_no_group_on_card(cuda_device, tmp_path):
    """A mesh on an NCCL group of one rank gives the no-group mesh's step
    bitwise (the collectives are copies, the arithmetic the same)."""
    import torch.distributed as dist

    from mfcc_rust_tpu_torch.parallel import extraction_step_packed, make_mesh, pack_signals
    from mfcc_rust_tpu_torch.parallel.mesh import init_process_group

    clips, lengths, t = _corpus_batch(32)
    cfg = P.speechpy_config(16000)
    flat, offs, lens = pack_signals(clips, 4, pcm16_exact=True)
    ref = extraction_step_packed(flat, offs, lens, t, cfg, make_mesh(device=cuda_device))
    assert init_process_group(f"file://{tmp_path / 'pg'}", 1, 0, device=cuda_device) == (0, 1)
    try:
        mesh = make_mesh(device=cuda_device)
        assert mesh.group is not None
        got = extraction_step_packed(flat, offs, lens, t, cfg, mesh)
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(ref)):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
