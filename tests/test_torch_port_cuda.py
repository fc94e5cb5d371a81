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

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
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
    # the chunk-GEMM path sums X_0 in float64 too (features._exact_edges), so
    # it is held at the headline's 53k random frames, some of whose X_0
    # nearly cancel, as well
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


# (name, speechpy_config kwargs, input shape): the edge kernel's cases
EDGES = [
    ("default 20/10", {}, (2, 8000)),
    ("25/10 r=3", {"frame_length": 0.025}, (2, 8000)),
    ("hann", {"window": "hann"}, (2, 8000)),
    ("batched 3-D", {}, (2, 2, 4000)),
    ("T no multiple of hop", {}, (3, 8001)),
    ("suite cell", {}, (64, 177664)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", EDGES, ids=[c[0] for c in EDGES])
def test_edge_kernel_matches_plain_on_card(cuda_device, name, kw, shape):
    """The chunk-GEMM product with X_0 and X_{N/2} from the edge kernel
    against the same from the plain float64 sums: the three columns equal to
    float32 rounding of a float64 sum (both round one float64 sum once), every
    other column bit for bit."""
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ek

    cfg = P.speechpy_config(16000, **kw)
    x = torch.from_numpy(np.random.default_rng(16).normal(0, 0.1, shape).astype(np.float32))
    x = x.to(cuda_device)
    n = (shape[-1] - cfg.frame_size) // cfg.frame_step
    c = PF._speechpy_tensors(cfg, x.device, x.dtype)
    ch, y = PF._chunk_gemm(x, c["wall"], n, cfg.frame_step)
    want = PF._exact_edges_plain(ch, y.clone(), cfg, n)
    before = ek.edge_sums.launches
    got = PF._exact_edges(x, ch, y.clone(), cfg, n)
    torch.cuda.synchronize()
    assert ek.edge_sums.launches == before + 1
    k = PF.constant_bundle(cfg)["fbank_kmax"]
    cols = [0, 2 * k, 2 * k + 1]
    torch.testing.assert_close(got[..., cols], want[..., cols], rtol=2 ** -23, atol=1e-12)
    rest = [j for j in range(y.shape[-1]) if j not in cols]
    assert torch.equal(got[..., rest], y[..., rest]), name


@pytest.mark.cuda
def test_extract_takes_the_edge_kernel_unless_asked_not_to_on_card(cuda_device):
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ek

    cfg = P.speechpy_config(16000)
    x = torch.from_numpy(np.random.default_rng(17).normal(0, 0.1, (4, 16000)).astype(np.float32))
    heads = ("mfe", "lmfe", "ssc", "mfcc")
    before = ek.edge_sums.launches
    got = PF.extract(x.to(cuda_device), cfg, heads)
    assert ek.edge_sums.launches == before + 1
    plain = PF.extract(x.to(cuda_device), cfg.replace(pallas="off"), heads)
    cpu = PF.extract(x, cfg, heads)
    assert ek.edge_sums.launches == before + 1
    # 1e-5, and 3e-5 for the logs, as tests/test_torch_port_extract.py holds
    # two float32 programs that sum in different orders
    for ref in (plain, cpu):
        assert rel(got["mfe"][0], ref["mfe"][0]) <= 1e-5 and rel(got["mfe"][1], ref["mfe"][1]) <= 1e-5
        assert rel(got["ssc"], ref["ssc"]) <= 1e-5
        assert rel(got["lmfe"], ref["lmfe"]) <= 3e-5 and rel(got["mfcc"], ref["mfcc"]) <= 3e-5
    a = x.to(cuda_device).requires_grad_(True)  # a gradient takes the plain sums
    PF.extract(a, cfg, ("mfcc",))["mfcc"].sum().backward()
    assert ek.edge_sums.launches == before + 1 and torch.isfinite(a.grad).all()


@pytest.mark.cuda
def test_replayed_extract_counts_the_edge_kernel_on_card(cuda_device):
    """``api.extract`` replays its CUDA graph after the first call, and each
    replay counts the edge kernel's launch, as the graph layer counts K1's
    and K2's."""
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ek

    x = torch.from_numpy(np.random.default_rng(19).normal(0, 0.1, (4, 16000)).astype(np.float32))
    x = x.to(cuda_device)
    heads = ("mfe", "lmfe", "ssc", "mfcc")
    first = P.extract(x, 16000, which=heads)
    ek.edge_sums.launches = 0
    for _ in range(3):
        out = P.extract(x, 16000, which=heads)
    torch.cuda.synchronize()
    assert ek.edge_sums.launches == 3
    assert rel(out["lmfe"], first["lmfe"]) <= 1e-6 and rel(out["mfcc"], first["mfcc"]) <= 1e-6


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


# (name, librosa_config args, kwargs, rows, samples a row, K2's path): the
# three direct K2 cells' shapes, the shortest rows K2 stages (n/2 + 1
# samples), T % 4 of 1, 2 and 3 on each path, rows shorter than a frame
# (each frame reads both pads) and an odd hop
_WHISPER = ((16000, 400, 160, 400, 128), {})
_L80 = ((16000,), dict(n_fft=512, hop_length=160, n_mels=80))
_P2 = ((16000,), dict(n_fft=768, hop_length=192, n_mels=64))
STAGED = [
    ("whisper cell", *_WHISPER, 64, 480_000, 3),
    ("librosa 80 cell", *_L80, 64, 160_000, 1),
    ("librosa 128 cell", (22050,), {}, 32, 220_500, 1),
    ("n/2 + 1, path 1", *_L80, 3, 257, 1),
    ("n/2 + 1, path 2", *_P2, 3, 385, 2),
    ("n/2 + 1, path 3", *_WHISPER, 3, 201, 3),
    ("T%4=1, path 1", *_L80, 3, 16_001, 1),
    ("T%4=2, path 1", (22050,), {}, 3, 22_050, 1),
    ("T%4=3, path 1", *_L80, 3, 16_003, 1),
    ("T%4=1, path 2", *_P2, 3, 16_001, 2),
    ("T%4=2, path 2", *_P2, 3, 16_002, 2),
    ("T%4=3, path 2", *_P2, 3, 16_003, 2),
    ("T%4=1, path 3", *_WHISPER, 3, 16_001, 3),
    ("T%4=2, path 3", *_WHISPER, 3, 16_002, 3),
    ("T%4=3, path 3", *_WHISPER, 3, 16_003, 3),
    ("frames across both pads", (22050,), {}, 2, 1_500, 1),
    ("odd hop", (16000,), dict(n_fft=512, hop_length=161, n_mels=64), 2, 8_003, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,args,kw,rows,t,path", STAGED, ids=[c[0] for c in STAGED])
def test_staged_reflect_pad_is_the_padded_launch_bit_for_bit_on_card(cuda_device, name, args, kw,
                                                                     rows, t, path):
    """``ct_mel`` under a centred reflect-mode config launches once on the
    unpadded rows, the kernel staging the pad (``reflect_launches``), and
    writes exactly what the centre pad and an uncentred launch write."""
    from mfcc_rust_tpu_torch.ops.framing import center_pad

    cfg = P.librosa_config(*args, **kw)
    x = torch.from_numpy(np.random.default_rng(t).normal(0, 0.1, (rows, t)).astype(np.float32))
    xd = x.to(cuda_device)
    assert ck.path_for(cfg) == path and ck.staged_half(xd, cfg) == cfg.fft_points // 2
    n0, r0 = ck.ct_mel.launches, ck.reflect_launches.launches
    got = ck.ct_mel(xd, cfg)
    torch.cuda.synchronize()
    assert (ck.ct_mel.launches - n0, ck.reflect_launches.launches - r0) == (1, 1)
    want = ck.ct_mel(center_pad(xd, cfg), cfg.replace(center=False))
    assert ck.reflect_launches.launches - r0 == 1
    assert tuple(got.shape) == (rows, 1 + t // cfg.frame_step, cfg.num_filters)
    assert torch.equal(got, want), name
    k = min(rows, 3)
    assert rel(got[:k], ck.ct_mel_plain(xd[:k], cfg)) <= 1e-4, name


# One direct call traced in a fresh process: in one process, after other
# tests, a profiler session has kept only a call's last kernel (H100, torch
# 2.11), so the traced calls run apart from the other tests.
TRACE_CALL = """
import json, sys
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck
name, shape, kw, on_card = json.loads(sys.argv[1])
x = torch.from_numpy(np.random.default_rng(31).normal(0, 0.1, shape).astype(np.float32)).cuda()
for k in on_card:
    kw[k] = torch.tensor(kw[k], dtype=torch.int64, device="cuda")
getattr(P, name)(x, **kw)
torch.cuda.synchronize()
r0, d0 = ck.reflect_launches.launches, PA.paths.read()["direct"]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    getattr(P, name)(x, **kw)
    torch.cuda.synchronize()
device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
with profile(activities=[ProfilerActivity.CPU]) as prof:
    getattr(P, name)(x, **kw)
    torch.cuda.synchronize()
print(json.dumps({"device": device, "host": [e.name for e in prof.events()],
                  "reflect": ck.reflect_launches.launches - r0,
                  "direct": PA.paths.read()["direct"] - d0}))
"""


def traced_call(name: str, shape: tuple, kw: dict, on_card: tuple = ()) -> dict:
    """``P.<name>(x, **kw)`` on a seeded (shape) batch on the card, the
    entries of ``kw`` named in ``on_card`` made int64 tensors on the card
    first, in a fresh process: after a first call, the second call's device
    events (every kernel, copy and set, all but the spans' annotations),
    the third call's host events, and the direct calls and staged
    reflections of the second and third together."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    arg = json.dumps([name, shape, kw, list(on_card)])
    res = subprocess.run([sys.executable, "-c", TRACE_CALL, arg],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(sr=22050), _L80[1] | dict(sr=16000)],
                         ids=["librosa 128", "librosa 80"])
def test_direct_librosa_call_launches_no_pad_on_card(cuda_device, kw):
    """The direct ``mel_spectrogram_librosa`` (one launch of K2) traces K2
    and no ``reflection_pad1d``, and counts one staged reflection."""
    got = traced_call("mel_spectrogram_librosa", (4, 44_100), kw)
    assert not any("reflection_pad" in k for k in got["device"] + got["host"]), got
    assert len(got["device"]) == 1 and "ct_mel" in got["device"][0], got["device"]
    assert (got["reflect"], got["direct"]) == (2, 2)


@pytest.mark.cuda
def test_graphed_calls_replay_no_staged_reflection_on_card(cuda_device):
    """A graphed librosa call (its fill writes the centre pad) launches K2
    uncentred: each replay re-adds its K2 launch and no staged reflection;
    each direct call counts one."""
    x = torch.from_numpy(np.random.default_rng(32).normal(0, 0.1, (2, 16_000))
                         .astype(np.float32)).to(cuda_device)
    kw = _L80[1] | dict(sr=16000)
    P.log_mel_spectrogram(x, **kw)  # the capture
    torch.cuda.synchronize()
    n0, r0 = ck.ct_mel.launches, ck.reflect_launches.launches
    for _ in range(3):
        P.log_mel_spectrogram(x, **kw)
    torch.cuda.synchronize()
    assert (ck.ct_mel.launches - n0, ck.reflect_launches.launches - r0) == (3, 0)
    for _ in range(3):
        P.mel_spectrogram_librosa(x, **kw)
    torch.cuda.synchronize()
    assert (ck.ct_mel.launches - n0, ck.reflect_launches.launches - r0) == (6, 3)


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
# and the sizes and hops around it, path 3 (the 8 x 25 register FFT) at
# Whisper's n_fft 400, path 2 (Stockham stages) elsewhere
K2_PATHS = [
    ("2048/512 headline", (22050,), {}, (32, 220500), 1),
    ("1024/256", (16000,), dict(n_fft=1024, hop_length=256), (2, 16000), 1),
    ("512/160/80", (16000,), dict(n_fft=512, hop_length=160, n_mels=80), (2, 16000), 1),
    ("256/64", (8000,), dict(n_fft=256, n_mels=40), (2, 8000), 1),
    ("2048/100", (22050,), dict(hop_length=100), (2, 16000), 1),
    ("2048/333 odd hop", (22050,), dict(hop_length=333), (2, 16001), 1),
    ("400/160/128 Whisper", (16000,), dict(n_fft=400, hop_length=160, n_mels=128),
     (3, 16000), 3),
    ("400/161 odd hop", (16000,), dict(n_fft=400, hop_length=161, n_mels=80), (2, 16001), 3),
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
        write, padded, cfg, _ = PA._writer(torch.from_numpy(x), cfg, True, cuda_device)
        xd = write(torch.empty(padded, device=cuda_device))
    else:
        xd = torch.from_numpy(x).to(cuda_device)
    t = xd.shape[-1] + (cfg.fft_points if cfg.center else 0)
    frames = 1 + (t - cfg.fft_points) // cfg.frame_step
    assert ck.path_for(cfg) == path, name
    plan = ck.launch_plan(cfg, int(np.prod(xd.shape[:-1])), frames)
    assert plan["path"] == path and plan["grid"] >= 1, (name, plan)
    before, paths = ck.ct_mel.launches, ck.path_counts()
    out = ck.ct_mel(xd, cfg)
    torch.cuda.synchronize()
    assert ck.ct_mel.launches == before + 1, name
    after = ck.path_counts()
    assert {p: after[p] - paths[p] for p in after} == {p: int(p == path) for p in after}, name
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


def _stream_chunks(seed, cfg, feature, size, n=32000):
    """Seeded chunks of ``size`` samples (0: ragged, 1-4,000), with one of 85
    hops third, so the carried step meets every ``K_BUCKETS`` size."""
    rng = np.random.default_rng(seed)
    hop = cfg.stream_hop if feature == "stft" else cfg.frame_step
    x = rng.normal(0, 0.1, n + 85 * hop + 7).astype(np.float32)
    sizes = list(rng.integers(1, 4001, 40)) if size == 0 else [size] * (n // size)
    sizes.insert(2, 85 * hop + (0 if feature == "stft" else 7))
    ends = np.cumsum(sizes)
    return [x[e - k:e] for k, e in zip(sizes, ends) if e <= x.size]


def _session_graphs(sess):
    inc = getattr(sess, "_inc", None)
    return inc._graphs if inc is not None else sess._graphs


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,feature,size,path", STREAMING, ids=[c[0] for c in STREAMING])
def test_streaming_sessions_replay_equal_to_eager_on_card(cuda_device, name, cfg, feature,
                                                          size, path):
    """A session replaying its own CUDA graphs returns, call by call, the
    eager session's rows bit for bit, with the eager session's K1 and K2
    launches (the recompute sessions' kernels inside their graphs), and
    captures each key once."""
    from mfcc_rust_tpu_torch.utils import graphs

    chunks = _stream_chunks(25, cfg, feature, size)
    eager, replayed = _session(cfg, feature, cuda_device), _session(cfg, feature, cuda_device)
    counts = []
    for sess, ctx in ((eager, graphs.disabled), (replayed, contextlib.nullcontext)):
        before = _launches()
        with ctx():
            outs = [sess.process(c) for c in chunks]
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(_launches(), before)))
        if sess is eager:
            ref = outs
    for got, want in zip(outs, ref):
        for a, b in zip(_leaves(got), _leaves(want)):
            assert a.is_cuda and torch.equal(a, b), name
    emitting = sum(_leaves(o)[0].shape[0] > 0 for o in ref)
    per_call = {("recompute", "mfcc"): (1, 0), ("recompute", "mel_librosa"): (0, 1)}
    want = tuple(emitting * k for k in per_call.get((path, feature), (0, 0)))
    assert counts[0] == counts[1] == want, (name, counts, want)
    cache = _session_graphs(replayed)
    assert _session_graphs(eager).captures == 0
    assert cache.captures == len(cache) and cache.replays > 0
    if path == "incremental":
        assert cache.captures <= 4
    st = cache.stats()
    assert st["pool_bytes"] > 0 and st["bytes"] == st["pool_bytes"] + st["static_bytes"] + \
        st["state_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,feature,size,path", [STREAMING[i] for i in (0, 2, 4, 5)],
                         ids=[STREAMING[i][0] for i in (0, 2, 4, 5)])
def test_streaming_reset_in_place_under_replay_on_card(cuda_device, name, cfg, feature, size,
                                                       path):
    """``reset()`` mid-stream zeroes the carry where the graphs read it: the
    same chunks again give the same rows, from the same state tensors."""
    chunks = _stream_chunks(26, cfg, feature, size, n=16000)
    sess = _session(cfg, feature, cuda_device)
    state = ((sess._carry,) if path == "stft" else
             (sess._inc.pending, sess._inc.pending_e) if path == "incremental" else ())
    ptrs = [t.data_ptr() for t in state]
    first = [sess.process(c) for c in chunks]
    for c in chunks[:3]:
        sess.process(c)
    sess.reset()
    again = [sess.process(c) for c in chunks]
    torch.cuda.synchronize()
    for a, b in zip(again, first):
        for u, v in zip(_leaves(a), _leaves(b)):
            assert torch.equal(u, v), name
    new_state = ((sess._carry,) if path == "stft" else
                 (sess._inc.pending, sess._inc.pending_e) if path == "incremental" else ())
    assert [t.data_ptr() for t in new_state] == ptrs
    assert _session_graphs(sess).replays > 0


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


@pytest.mark.cuda
def test_entry_fn_launches_k1_once_on_card(cuda_device):
    from mfcc_rust_tpu_torch.entry import entry

    fn, (x0,) = entry()
    assert x0.is_cuda and x0.dtype == torch.float32 and tuple(x0.shape) == (8, 16000)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (8, 16000)).astype(np.float32))
    cfg = P.FeatureConfig(sample_rate=16000)
    for sig in (x0, x.to(cuda_device)):
        before = pk.mfcc_fused.launches
        got = fn(sig)
        assert pk.mfcc_fused.launches == before + 1
        assert tuple(got.shape) == (8, 98, 13) and bool(torch.isfinite(got).all())
        # the zero batch: -log(eps) everywhere, equal up to rounding
        assert rel(got, pk.mfcc_fused_plain(sig, cfg)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.EXAMPLES)
def test_examples_launch_the_kernels_on_card(cuda_device, name):
    """Each example on the card launches ``chip_smoke.EXAMPLE_LAUNCHES``,
    holds every launch to its kernel's plain version at 1e-4 and prints
    the lines of its CPU run."""
    with chip_smoke.held_to_plain(pk, ck) as readings:
        before = (pk.mfcc_fused.launches, ck.ct_mel.launches)
        _, lines = chip_smoke.run_example(name, "cuda")
        launches = (pk.mfcc_fused.launches - before[0], ck.ct_mel.launches - before[1])
    _, cpu_lines = chip_smoke.run_example(name, "cpu")
    assert launches == chip_smoke.EXAMPLE_LAUNCHES[name], (launches, lines)
    assert (len(readings["k1"]), len(readings["k2"])) == launches
    assert max(readings["k1"] + readings["k2"], default=0.0) <= 1e-4, readings
    assert chip_smoke.example_lines_differ(lines, cpu_lines) == []


# The compiled-call layer (utils/graphs.py): each entry point that the JAX
# package jits, and each pipeline, on a CUDA input that needs no gradient
# captures one graph and replays it; a replay is held to the eager call
# (graphs.disabled()) at 1e-6 of max|ref| (both run the same kernels on the
# same values; the replay is expected bitwise).  The calls of DIRECT are one
# launch of K1 (api._k1_alone) or the centre pad and one launch of K2
# (api._k2_alone): they launch it on the caller's signal and capture and
# replay nothing.
SP, LB = P.speechpy_config(16000), P.librosa_config(22050)
# (name, a function making the callable, (K1, K2) launches a call)
GRAPHED = [
    ("api.mfcc", lambda: lambda x: P.mfcc(x, 16000), (1, 0)),
    ("api.mfe", lambda: lambda x: P.mfe(x, 16000), (0, 0)),
    ("api.lmfe", lambda: lambda x: P.lmfe(x, 16000), (0, 0)),
    ("api.ssc", lambda: lambda x: P.ssc(x, 16000), (0, 0)),
    ("api.extract", lambda: lambda x: P.extract(x, 16000, which=HEADS), (0, 0)),
    ("api.mel_spectrogram", lambda: lambda x: P.mel_spectrogram(x, 16000), (0, 0)),
    ("api.mel_spectrogram_librosa", lambda: P.mel_spectrogram_librosa, (0, 1)),
    ("api.log_mel_spectrogram", lambda: P.log_mel_spectrogram, (0, 1)),
    ("api.mfcc_librosa", lambda: P.mfcc_librosa, (0, 1)),
    ("MFCCPipeline", lambda: P.MFCCPipeline(SP), (1, 0)),
    ("MFEPipeline", lambda: P.MFEPipeline(SP), (0, 0)),
    ("LogMFEPipeline", lambda: P.LogMFEPipeline(SP), (0, 0)),
    ("SSCPipeline", lambda: P.SSCPipeline(SP), (0, 0)),
    ("MelSpectrogramPipeline", lambda: P.MelSpectrogramPipeline(SP), (0, 0)),
    ("LibrosaMelPipeline", lambda: P.LibrosaMelPipeline(LB), (0, 1)),
    ("LibrosaMFCCPipeline", lambda: P.LibrosaMFCCPipeline(LB), (0, 1)),
    ("FeatureExtractor", lambda: P.FeatureExtractor(SP), (1, 0)),
]
DIRECT = {"api.mfcc", "api.mel_spectrogram_librosa"}


@pytest.fixture
def graph_cache(cuda_device):
    from mfcc_rust_tpu_torch.utils import graphs

    graphs.cache.clear()
    yield graphs
    graphs.cache.clear()


def _leaves(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, tuple):
        return [t for v in out for t in _leaves(v)]
    return [out]


def _launches():
    return pk.mfcc_fused.launches, ck.ct_mel.launches


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,want", GRAPHED, ids=[c[0] for c in GRAPHED])
def test_entry_points_replay_a_graph_equal_to_eager_on_card(graph_cache, name, make, want):
    graphs = graph_cache
    rng = np.random.default_rng(40)
    xs = [torch.from_numpy(rng.normal(0, 0.1, (2, 16000)).astype(np.float32)).cuda()
          for _ in range(3)]
    fn = make()
    outs, counts = [], []
    for i, x in enumerate(xs):
        before, (c0, r0) = _launches(), (graphs.cache.captures, graphs.cache.replays)
        with graphs.disabled():
            eager = fn(x)
        torch.cuda.synchronize()
        eager_launches = tuple(a - b for a, b in zip(_launches(), before))
        before = _launches()
        got = fn(x)
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(_launches(), before)))
        assert eager_launches == counts[-1] == want, (name, i, eager_launches, counts[-1])
        # the first call captures, every later one replays: never eagerly
        # (a direct call neither)
        assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == \
            ((0, 0) if name in DIRECT else (1, 0) if i == 0 else (0, 1)), name
        for a, b in zip(_leaves(got), _leaves(eager)):
            assert a.is_cuda and a.shape == b.shape
            assert rel(a, b) <= 1e-6, (name, i, rel(a, b))
        outs.append(got)
    # results are fresh tensors: the first replay's survives the second
    with graphs.disabled():
        again = fn(xs[1])
    for a, b in zip(_leaves(outs[1]), _leaves(again)):
        assert rel(a, b) <= 1e-6, name


@pytest.mark.cuda
def test_bucket_tail_and_centre_pad_rewritten_per_call_on_card(graph_cache):
    graphs = graph_cache
    c0, r0 = graphs.cache.captures, graphs.cache.replays
    rng = np.random.default_rng(41)
    calls = [(lambda x: P.mfcc(x, 16000), (15000, 13000)),
             (lambda x: P.ssc(x, 16000), (15000, 13000)),
             (lambda x: P.mel_spectrogram_librosa(x), (21000, 20000)),
             (lambda x: P.log_mel_spectrogram(x), (21000, 20000)),
             (lambda x: P.mfcc_librosa(x, center=False), (23000, 21000))]
    for fn, lengths in calls:
        for n in lengths + lengths[:1]:
            x = rng.normal(0, 0.1, (2, n)).astype(np.float32)
            got = fn(x)
            with graphs.disabled():
                ref = fn(x)
            assert rel(got, ref) <= 1e-6, n
    # one bucket each: one capture, two replays; none for api.mfcc and
    # api.mel_spectrogram_librosa (in place)
    assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (3, 6)


@pytest.mark.cuda
def test_launches_are_counted_per_replay_on_card(graph_cache):
    graphs = graph_cache
    x = torch.from_numpy(np.random.default_rng(42).normal(0, 0.1, (4, 16000))
                         .astype(np.float32)).cuda()
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ek

    c0, r0 = graphs.cache.captures, graphs.cache.replays
    before, edges = _launches(), ek.edge_sums.launches
    for _ in range(3):
        P.mfcc(x, 16000)
        P.mel_spectrogram_librosa(x, 16000, n_fft=512, hop_length=160)
        P.log_mel_spectrogram(x, 16000, n_fft=512, hop_length=160)
        P.extract(x, 16000, which=("lmfe",))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (3, 6)
    assert ek.edge_sums.launches - edges == 3
    # api.mfcc and api.mel_spectrogram_librosa launch in place: no graph of them
    assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (2, 4)
    g = list(graphs.cache._graphs.values())
    # (K1, K2, the edge sums, the heads, the Whisper finish, the NeMo
    # prologue and finish, then K2 by path 1, 2, 3, then K2's staged
    # reflections: none, the graph's K2 reads the fill's padded rows) a replay
    assert sorted(e.launches for e in g) == [(0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                                             (0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0)]


@pytest.mark.cuda
def test_inputs_needing_a_gradient_run_eagerly_on_card(graph_cache):
    graphs = graph_cache
    x = torch.from_numpy(np.random.default_rng(43).normal(0, 0.1, (2, 8000))
                         .astype(np.float32)).cuda().requires_grad_(True)
    c0, before = graphs.cache.captures, _launches()
    (P.mfcc(x, 16000).sum() + P.MFCCPipeline(SP)(x).sum()).backward()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 0)
    assert graphs.cache.captures == c0 and len(graphs.cache) == 0
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_a_failed_capture_raises_on_card(graph_cache):
    graphs = graph_cache
    cache = graphs.GraphCache()
    with pytest.raises(Exception):
        # float() reads the result back: a capture cannot
        cache.run(("sync",), lambda s: s * float(s.sum()), (4,), torch.float32,
                  torch.device("cuda"), lambda s: s.fill_(1.0))
    assert len(cache) == 0 and cache.captures == 0
    # the layer goes on afterwards (api.mfcc launches K1 in place: no replay)
    r0 = graphs.cache.replays
    x = torch.zeros((2, 16000), device="cuda")
    out = P.mfcc(x, 16000)
    out2 = P.mfcc(x + 0.1, 16000)
    torch.cuda.synchronize()
    assert graphs.cache.replays == r0 and bool(torch.isfinite(out2).all()) and out.is_cuda
    P.ssc(x, 16000)
    out3 = P.ssc(x + 0.1, 16000)
    torch.cuda.synchronize()
    assert graphs.cache.replays == r0 + 1 and bool(torch.isfinite(out3).all())


@pytest.mark.cuda
def test_eviction_frees_the_pool_on_card(graph_cache):
    import gc

    graphs = graph_cache
    cache = graphs.GraphCache(maxsize=1)
    big = (64, 1 << 20)  # a 256 MB intermediate in the graph's pool
    fn = lambda s: (s * 2.0 + 1.0).sum(-1)
    dev = torch.device("cuda")
    fill = lambda s: s.fill_(1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = cache.run(("a",), fn, big, torch.float32, dev, fill)
    (ga,) = cache._graphs.values()
    pool, held = ga.graph.pool(), ga.pool_bytes()
    assert held >= 256 << 20 and float(out[0]) == 3.0 * (1 << 20)
    assert float(cache.run(("a",), fn, big, torch.float32, dev, fill)[0]) == 3.0 * (1 << 20)
    del ga, out
    cache.run(("b",), lambda s: s + 1.0, (4,), torch.float32, dev, fill)  # evicts "a"
    assert len(cache) == 1
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = [s for s in torch.cuda.memory_snapshot() if s["segment_pool_id"] == pool]
    assert left == [], [s["total_size"] for s in left]


def _clear_tensor_caches():
    """Empty every tensor cache of the port (``constants.tensor_cache``)."""
    import sys

    from mfcc_rust_tpu_torch import constants as pc

    for name, mod in list(sys.modules.items()):
        if name.startswith("mfcc_rust_tpu_torch"):
            for f in list(vars(mod).values()):
                info = getattr(f, "cache_info", None)
                if callable(info) and type(info()) is pc.CacheInfo:
                    f.cache_clear()


@pytest.mark.cuda
def test_replays_survive_the_tensor_caches_dropping_their_constants_on_card(graph_cache):
    """A graph reads its constants (the kernels' tables, the DFT walls, the
    filterbanks) at the addresses it captured.  Once every tensor cache has
    dropped them and memory of each one's size has been taken and filled
    with NaN, a replay must still equal the eager call: the graph keeps
    what it reads."""
    import gc

    from mfcc_rust_tpu_torch import constants as pc

    graphs = graph_cache
    x = torch.from_numpy(np.random.default_rng(45).normal(0, 0.1, (2, 16000))
                         .astype(np.float32)).cuda()
    calls = [lambda x: P.mfcc(x, 16000), lambda x: P.ssc(x, 16000),
             lambda x: P.mel_spectrogram(x, 16000),
             lambda x: P.mel_spectrogram_librosa(x, 16000, n_fft=512, hop_length=160),
             lambda x: P.mfcc_librosa(x, 16000, n_fft=512, hop_length=160)]
    refs, sizes = [], set()
    for fn in calls:
        fn(x)  # captures
        with pc.holding() as held, graphs.disabled():
            refs.append(fn(x))
        sizes.update(t.numel() * t.element_size() for v in held for t in graphs._tensors(v)
                     if t.is_cuda)
        del held
    torch.cuda.synchronize()
    c0, r0 = graphs.cache.captures, graphs.cache.replays
    _clear_tensor_caches()
    gc.collect()
    junk = []  # on the caller's stream and the cache's, where the warm-ups built them
    for s in [torch.cuda.current_stream(), *graphs._streams.values()]:
        with torch.cuda.stream(s):
            junk += [torch.full((max(n // 4, 1),), float("nan"), device="cuda")
                     for n in sorted(sizes) for _ in range(4)]
    torch.cuda.synchronize()
    for fn, ref in zip(calls, refs):
        assert rel(fn(x), ref) <= 1e-6
    # every call but api.mfcc and api.mel_spectrogram_librosa (in place, no
    # graph) replays
    assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (0, len(calls) - 2)
    del junk


@pytest.mark.cuda
def test_calls_on_two_streams_each_get_their_own_result_on_card(graph_cache):
    """Two streams call one graph at once (each behind a device spin of the
    same length, so their work would overlap on the device): each result
    must be its own input's, as the eager call gives it."""
    graphs = graph_cache
    rng = np.random.default_rng(46)
    xs = [torch.from_numpy(rng.normal(0, 0.1, (16, 160000)).astype(np.float32)).cuda()
          for _ in range(2)]
    pipe = P.MFCCPipeline(SP)
    with graphs.disabled():
        refs = [pipe(x) for x in xs]
    pipe(xs[0])  # captures
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    r0 = graphs.cache.replays
    for _ in range(5):
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        outs = []
        for s, x in zip(streams, xs):
            with torch.cuda.stream(s):
                outs.append(pipe(x))
        torch.cuda.synchronize()
        for out, ref in zip(outs, refs):
            assert rel(out, ref) <= 1e-6
    assert graphs.cache.replays - r0 == 10


# api.mfcc whose lowering is K1 alone: K1 launched once on the caller's
# signal at its true length, no graph; the answer is the eager (bucketed)
# call's within 1e-6 of max|ref| (the kept frames read the same samples:
# expected bitwise), at lengths on a bucket's edge, one short of a hop and
# between buckets, device-resident or from numpy, 2-D and 3-D.
DIRECT_CALLS = [(n, dims, src) for n in (160_000, 15_999, 13_001)
                for dims in ((4,), (2, 2)) for src in ("device", "numpy")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dims,src", DIRECT_CALLS,
                         ids=[f"{n} {len(d) + 1}-D {s}" for n, d, s in DIRECT_CALLS])
def test_mfcc_of_one_k1_launch_runs_in_place_on_card(graph_cache, n, dims, src):
    graphs = graph_cache
    rng = np.random.default_rng(n)
    host = rng.normal(0, 0.1, dims + (n,)).astype(np.float32)
    x = torch.from_numpy(host).cuda() if src == "device" else host
    with graphs.disabled():
        ref = P.mfcc(x, 16000)
    frames = PA._frames_nopad(PA._speechpy_cfg(16000), n)
    for bucket in (True, False, True):
        c0, r0, before = graphs.cache.captures, graphs.cache.replays, _launches()
        got = P.mfcc(x, 16000, bucket=bucket)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 0)
        assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (0, 0)
        assert got.is_cuda and tuple(got.shape) == dims + (frames, 13)
        assert rel(got, ref) <= 1e-6, (bucket, rel(got, ref))
    assert len(graphs.cache) == 0


@pytest.mark.cuda
def test_mfcc_in_place_on_two_streams_each_get_their_own_result_on_card(graph_cache):
    """Two streams call ``api.mfcc`` at once, each behind a device spin of
    the same length: K1 runs on each caller's stream into its own result."""
    graphs = graph_cache
    rng = np.random.default_rng(47)
    xs = [torch.from_numpy(rng.normal(0, 0.1, (16, 160000)).astype(np.float32)).cuda()
          for _ in range(2)]
    with graphs.disabled():
        refs = [P.mfcc(x, 16000) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before, c0 = _launches(), graphs.cache.captures
    for _ in range(5):
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        outs = []
        for s, x in zip(streams, xs):
            with torch.cuda.stream(s):
                outs.append(P.mfcc(x, 16000))
        torch.cuda.synchronize()
        for out, ref in zip(outs, refs):
            assert rel(out, ref) <= 1e-6
    assert tuple(a - b for a, b in zip(_launches(), before)) == (10, 0)
    assert graphs.cache.captures == c0 and len(graphs.cache) == 0


# api.mel_spectrogram_librosa whose lowering is K2 alone: the centre pad at
# the true length, then K2 launched once on the caller's stream, no graph;
# the answer is the same input's through api._run's graph, bit for bit,
# at both librosa cells' shapes.
K2_DIRECT = [("2048/512/128", {"sr": 22050}, (32, 220_500)),
             ("512/160/80", {"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 80},
              (64, 160_000))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,shape", K2_DIRECT, ids=[c[0] for c in K2_DIRECT])
def test_mel_spectrogram_librosa_of_one_k2_launch_runs_in_place_on_card(graph_cache, name, kw,
                                                                        shape):
    graphs = graph_cache
    x = torch.from_numpy(np.random.default_rng(48).normal(0, 0.1, shape)
                         .astype(np.float32)).cuda()
    cfg = PA._librosa_cfg(kw["sr"], kw.get("n_fft", 2048), kw.get("hop_length", 512), None,
                          kw.get("n_mels", 128), 20, 0.0, None, 2.0, True)
    dev = torch.device("cuda")
    assert PA._k2_alone(cfg, x, dev)
    c0, r0 = graphs.cache.captures, graphs.cache.replays
    for _ in range(2):  # the capture, then a replay: the graph's answer
        out, n = PA._run(PF.mel_spectrogram_librosa, x, cfg, True, dev)
    graphed = out[..., :PA._librosa_frames(cfg, n)]
    torch.cuda.synchronize()
    assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (1, 1)
    frames = 1 + shape[1] // cfg.frame_step
    c0, r0 = graphs.cache.captures, graphs.cache.replays
    for bucket in (True, False, True):
        before = _launches()
        got = P.mel_spectrogram_librosa(x, **kw, bucket=bucket)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 1)
        assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (0, 0)
        assert got.is_cuda and tuple(got.shape) == (shape[0], cfg.num_filters, frames)
        assert torch.equal(got, graphed), (name, bucket, rel(got, graphed))


@pytest.mark.cuda
def test_mel_spectrogram_librosa_in_place_on_two_streams_each_get_their_own_result_on_card(
        graph_cache):
    """Two streams call ``api.mel_spectrogram_librosa`` at once, each behind a
    device spin of the same length: the centre pad and K2 run on each
    caller's stream into its own result."""
    graphs = graph_cache
    rng = np.random.default_rng(49)
    xs = [torch.from_numpy(rng.normal(0, 0.1, (32, 220_500)).astype(np.float32)).cuda()
          for _ in range(2)]
    with graphs.disabled():
        refs = [P.mel_spectrogram_librosa(x) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before, c0 = _launches(), graphs.cache.captures
    for _ in range(5):
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        outs = []
        for s, x in zip(streams, xs):
            with torch.cuda.stream(s):
                outs.append(P.mel_spectrogram_librosa(x))
        torch.cuda.synchronize()
        for out, ref in zip(outs, refs):
            assert rel(out, ref) <= 1e-6
    assert tuple(a - b for a, b in zip(_launches(), before)) == (0, 10)
    assert graphs.cache.captures == c0 and len(graphs.cache) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SSCPipeline", "MFCCPipeline", "MelSpectrogramPipeline"])
def test_framed_lowerings_replay_on_card(graph_cache, name):
    """Off the chunk-GEMM fast path (``fft_impl="fft"``: the framed
    lowering, the SSC ramp among its constants), every constant comes from
    a tensor cache the warm-up filled: nothing is uploaded inside the
    capture, which would fail it."""
    graphs = graph_cache
    cfg = P.speechpy_config(16000, fft_impl="fft")
    assert not PF._fast_path_ok(cfg)
    pipe = getattr(P, name)(cfg)
    rng = np.random.default_rng(44)
    c0 = graphs.cache.captures
    for _ in range(3):
        x = torch.from_numpy(rng.normal(0, 0.1, (2, 8000)).astype(np.float32)).cuda()
        got = pipe(x)
        with graphs.disabled():
            assert rel(got, pipe(x)) <= 1e-6
    assert graphs.cache.captures - c0 == 1


# ------------------------------------------------- corpus steps replayed --
def _corpus_step(run: str, seed: int, mesh):
    """One step of corpus run (a), (b) or (c) of ``chip_smoke.py`` on a
    batch of four clips in one bucket: (a) the packed ``"mfcc"`` step with
    packed outputs, K1 on its path; (b) the five speechpy heads on a
    float16 wire; (c) the unpack-and-resample pass of 22,050 Hz clips, then
    the padded ``"mfcc"`` step with packed outputs."""
    from mfcc_rust_tpu_torch.parallel import data as pdata

    cfg = P.speechpy_config(16000)
    heads = ("mfcc", "lmfe", "mfe", "ssc", "energy")
    clips, lengths, t = _corpus_batch(seed)
    if run == "c":
        src = [np.resize(c, int(len(c) * 22050 / 16000)) for c in clips]
        flat, offs, lens = pdata.pack_signals(src, 4, pcm16_exact=True)
        t_src = -(-(22050 * t // 16000) // 441) * 441  # the runner's source bucket
        sig = pdata.unpack_resample(flat, offs, lens, t_src, 320, 441, mesh)
        out_len = -(-lens * 320 // 441)
        counts = pdata.frame_counts_host(out_len, cfg, "mfcc")
        return sig, pdata.extraction_step(sig, out_len, cfg, mesh, "mfcc", frame_counts=counts)
    flat, offs, lens = pdata.pack_signals(clips, 4, pcm16_exact=True)
    feature = "mfcc" if run == "a" else heads
    counts = pdata.frame_counts_host(lens, cfg, "mfcc")
    return pdata.extraction_step_packed(flat, offs, lens, t, cfg, mesh, feature,
                                        frame_counts=counts,
                                        wire_dtype="float16" if run == "b" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("run,k1", [("a", 1), ("b", 0), ("c", 1)])
def test_corpus_steps_replay_equal_to_eager_on_card(cuda_device, run, k1):
    """Three batches of one bucket: the first call captures, the others
    replay; each equals the same step run eagerly bitwise, and each call,
    eager or replayed, counts K1 once on the ``"mfcc"`` paths (its graph's
    launch, added per replay) and never on the five heads."""
    from mfcc_rust_tpu_torch.parallel import data as pdata
    from mfcc_rust_tpu_torch.parallel import make_mesh
    from mfcc_rust_tpu_torch.utils import graphs

    mesh = make_mesh(device=cuda_device)
    pdata.steps.clear()
    c0, r0 = pdata.steps.captures, pdata.steps.replays
    for i, seed in enumerate((30, 31, 32)):
        before = pk.mfcc_fused.launches
        with graphs.disabled():
            ref = _corpus_step(run, seed, mesh)
        torch.cuda.synchronize()
        assert pk.mfcc_fused.launches - before == k1
        before = pk.mfcc_fused.launches
        got = _corpus_step(run, seed, mesh)
        torch.cuda.synchronize()
        assert pk.mfcc_fused.launches - before == k1, (run, i)
        for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(ref)):
            assert a.is_cuda and a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b), (run, i)
    per_call = 2 if run == "c" else 1  # the resample pass and the step
    assert (pdata.steps.captures - c0, pdata.steps.replays - r0) == (per_call, 2 * per_call)
    pdata.steps.clear()
