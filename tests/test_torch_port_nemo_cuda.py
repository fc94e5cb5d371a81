"""NeMo FastConformer's log-mel front end on the card: the prologue and
finish kernels (``ops/cuda/nemo_logmel.cu``) against their plain twins, K2's
plan at 512/160/128 with NeMo's window (path 1) and K2 there against its
plain version, and ``api.log_mel_spectrogram_nemo``'s direct path: its
launches, no host synchronisation, and its answer against the eager path,
the CPU plain path and the float64 reference.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX:

    python -m pytest tests/test_torch_port_nemo_cuda.py -m cuda --noconftest -q

Tolerances.  The prologue against its twin: equal bit for bit (each output
is one rounded product and one rounded difference in both), over the whole
buffer, or, where it writes the frame counts for K2's ragged rows, over
what each row's frames read.  The finish
against its twin on the same power: 5e-5 in max|Δ| of the normalised
answer: both take the same float32 logs, but the kernel's mean and
deviation are Welford's and Chan's over its own order of frames, the
twin's two passes over logs less the first frame, which differ by a few
ulps of |mean| (<= ~17, the guard's log), divided by deviations of a few
tenths and more.  The API answer against the plain path on the CPU and the
float64 reference (``tests/golden/nemo_ref.py``): 1e-3.  K2's float32 FFT
rounds a narrow band (one or two of 257 bins at 128 mels) whose power
nearly vanishes in a frame to a relative error that the log keeps: on the
cell's 64 rows of noise the card's answer reads ~2.6e-4 off float64, and
more rows and seeds reach further; the TF32 control reads ~0.4.
K2 against ``ct_mel_plain``: max|Δ|/max|ref| <= 1e-4, the tolerance its
path-1 cases have in ``tests/test_torch_port_cuda.py``, on ragged rows over
each row's own frames."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck
from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as nl
from tests.golden import nemo_ref

RATE, HOP = 16000, 160
FINISH_TOL = 5e-5
PLAIN_TOL = 1e-3
K2_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def graph_cache(cuda_device):
    from mfcc_rust_tpu_torch.utils import graphs

    graphs.cache.clear()
    yield graphs
    graphs.cache.clear()


def _err(a, ref):
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return (a - ref).abs().max().item() if ref.numel() else 0.0


def _ragged(rows, samples, seed, device, offset=0):
    """(rows, samples) noise with zeros past each row's length, and the
    int64 lengths on ``device``: rows of 0, 1, 159, 160 and 161 samples, a
    length past the row, a whole row, then lognormal ones; ``offset`` floats
    into a buffer, to misalign the rows."""
    rng = np.random.default_rng(seed)
    fixed = [0, 1, 159, 160, 161, samples + 999, samples]
    lens = np.array(fixed[:rows] + list(np.clip(
        rng.lognormal(np.log(max(samples, 3) / 3), 0.6, max(rows - len(fixed), 0)), 1, samples)
        .astype(np.int64)), dtype=np.int64)
    x = rng.normal(0.0, 0.1, (rows, samples)).astype(np.float32)
    for r, n in enumerate(lens):
        x[r, n:] = 0.0
    buf = torch.empty(x.size + offset, device=device)
    xd = buf[offset:].view(rows, samples)
    xd.copy_(torch.from_numpy(x))
    return xd, torch.from_numpy(lens).to(device)


# (name, rows, samples, offset): the cell's shape, a length that is no
# multiple of 4 (the scalar path), misaligned rows, one sample, none
PROLOGUE = [("cell 64x400000", 64, 400_000, 0), ("odd length", 9, 16_001, 0),
            ("misaligned", 9, 16_000, 1), ("one sample", 3, 1, 0), ("empty rows", 2, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,samples,offset", PROLOGUE, ids=[c[0] for c in PROLOGUE])
def test_prologue_kernel_matches_its_plain_twin_on_card(cuda_device, name, rows, samples, offset):
    cfg = PA._nemo_cfg(128)
    x, lens = _ragged(rows, samples, 41, cuda_device, offset)
    before = nl.nemo_prologue.launches
    got = nl.nemo_prologue(x, lens, cfg)
    torch.cuda.synchronize()
    assert nl.nemo_prologue.launches - before == 1
    assert tuple(got.shape) == (rows, samples + 512) and got.is_contiguous()
    assert torch.equal(got, nl.nemo_prologue_plain(x, lens, cfg)), name


@pytest.mark.cuda
def test_prologue_kernel_takes_leading_dims_and_negative_lengths_on_card(cuda_device):
    cfg = PA._nemo_cfg(80)
    x, _ = _ragged(6, 3_000, 42, cuda_device)
    x = x.reshape(2, 3, 3_000)
    lens = torch.tensor([[-5, 0, 2_999], [3_000, 7, 1_234]], device=cuda_device)
    got = nl.nemo_prologue(x, lens, cfg)
    assert tuple(got.shape) == (2, 3, 3_512)
    assert torch.equal(got, nl.nemo_prologue_plain(x, lens, cfg))
    assert bool((got[0, 0] == 0).all()) and bool((got[0, 1] == 0).all())


def _power(rows, frames, m, seed, device):
    """Mel powers (rows, frames, m): exponential noise over six decades, one
    row of silence, one mel constant over every frame."""
    g = torch.Generator().manual_seed(seed)
    p = (torch.empty(rows, frames, m).exponential_(generator=g)
         * 10 ** (6 * torch.rand(rows, frames, m, generator=g) - 4))
    p[1] = 0.0
    p[:, :, 3] = 0.25
    return p.to(device)


# (name, rows, frames, mels): the cell's shape, 80 mels, mels no multiple of
# 4, more than 128 mels (the wide statistics kernel), one frame, a long row
FINISH = [("cell 64x2501x128", 64, 2501, 128), ("80 mels", 9, 700, 80), ("83 mels", 9, 333, 83),
          ("200 mels", 9, 400, 200), ("one frame", 9, 1, 128), ("long row", 9, 20_001, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,frames,m", FINISH, ids=[c[0] for c in FINISH])
def test_finish_kernels_match_their_plain_twin_on_card(cuda_device, name, rows, frames, m):
    p = _power(rows, frames, m, 43, cuda_device)
    samples = (frames - 1) * HOP
    _, lens = _ragged(rows, samples, 44, cuda_device)
    before = nl.nemo_finish.launches
    got, seq = nl.nemo_finish(p, lens, HOP)
    torch.cuda.synchronize()
    want, want_seq = nl.nemo_finish_plain(p, lens, HOP)
    assert nl.nemo_finish.launches - before == 2
    assert got.is_contiguous() and tuple(got.shape) == (rows, m, frames)
    assert seq.dtype == torch.int64 and torch.equal(seq, want_seq)
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= FINISH_TOL, name
    n = seq.clamp(max=frames)
    for r in range(rows):  # zeros past each row's frames, and on the constant mel
        assert bool((got[r, :, int(n[r]):] == 0).all())
        assert bool((got[r, 3] == 0).all())


@pytest.mark.cuda
def test_k2_takes_path_1_at_nemos_shape_on_card(cuda_device):
    cfg = PA._nemo_cfg(128).replace(center=False)
    _, _, wpack, _, kmax = ck._kernel_constants(cfg)
    plan = ck.launch_plan(cfg, 64, 3501)
    assert plan["path"] == 1, plan
    assert plan["warps"] == ck.fft_warps(512, 160, kmax, wpack.size, 128), plan
    win = ck._kernel_constants(cfg)[0]
    sym = torch.hann_window(400, periodic=False, dtype=torch.float64).numpy()
    assert np.allclose(win[56:456], sym, atol=1e-7) and not win[:56].any() and not win[456:].any()


@pytest.mark.cuda
def test_k2_path_1_matches_plain_on_nemos_prologue_on_card(cuda_device):
    cfg = PA._nemo_cfg(128)
    x, lens = _ragged(16, 160_000, 45, cuda_device)
    xp = nl.nemo_prologue(x, lens, cfg)
    cu = cfg.replace(center=False)
    paths = ck.path_counts()
    got = ck.ct_mel(xp, cu)
    after = ck.path_counts()
    assert {p: after[p] - paths[p] for p in after} == {1: 1, 2: 0, 3: 0}
    ref = ck.ct_mel_plain(xp, cu)
    rel = _err(got, ref) / ref.abs().max().item()
    assert tuple(got.shape) == (16, 1001, 128) and rel <= K2_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,samples,offset", PROLOGUE, ids=[c[0] for c in PROLOGUE])
def test_prologue_kernel_writes_the_frame_counts_and_what_they_read_on_card(
        cuda_device, name, rows, samples, offset):
    """Given ``used``, the kernel writes each row's frame count there and
    the plain twin's samples as far as those frames read, min(len, T) +
    512 of them."""
    cfg = PA._nemo_cfg(128)
    x, lens = _ragged(rows, samples, 41, cuda_device, offset)
    used = torch.full_like(lens, -7)
    got = nl.nemo_prologue(x, lens, cfg, used)
    torch.cuda.synchronize()
    assert torch.equal(used, PF.nemo_feature_lengths(lens, HOP)), name
    want = nl.nemo_prologue_plain(x, lens, cfg)
    for r, n in enumerate(lens.clamp(0, samples).tolist()):
        assert torch.equal(got[r, : n + 512], want[r, : n + 512]), (name, r)


# (name, rows, samples, mels): the cell's shape, more rows than two of the
# cursor's 32-row windows at 80 mels, a few rows
RAGGED = [("cell 64x400000", 64, 400_000, 128), ("100 rows", 100, 48_000, 80),
          ("3 rows", 3, 16_000, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,samples,m", RAGGED, ids=[c[0] for c in RAGGED])
def test_k2_on_ragged_rows_matches_plain_on_each_rows_frames_on_card(cuda_device, name, rows,
                                                                       samples, m):
    """K2 with ``used`` runs path 1's ragged kernel once and matches its
    plain version on each row's first ``used`` frames (rows of none, of one,
    of more than the row holds); with every frame used it equals K2 without
    ``used`` bit for bit."""
    cfg = PA._nemo_cfg(m)
    cu = cfg.replace(center=False)
    x, lens = _ragged(rows, samples, 49, cuda_device)
    used = torch.empty_like(lens)
    xp = nl.nemo_prologue(x, lens, cfg, used)
    paths = ck.path_counts()
    got = ck.ct_mel(xp, cu, used)
    after = ck.path_counts()
    assert {p: after[p] - paths[p] for p in after} == {1: 1, 2: 0, 3: 0}
    ref = ck.ct_mel_plain(nl.nemo_prologue_plain(x, lens, cfg), cu)
    scale = ref.abs().max().item()
    frames = ref.shape[1]
    for r, n in enumerate(used.clamp(max=frames).tolist()):
        assert _err(got[r, :n], ref[r, :n]) / scale <= K2_TOL, (name, r)
    whole = torch.full_like(lens, frames)
    full = nl.nemo_prologue(x, lens, cfg)
    assert torch.equal(ck.ct_mel(full, cu, whole), ck.ct_mel(full, cu)), name


@pytest.mark.cuda
def test_k2_used_leaves_path_3_whole_on_card(cuda_device):
    """``used`` shortens path 1 only: path 3 (Whisper's n_fft 400) writes
    every frame."""
    cu = PA._whisper_cfg(128).replace(center=False)
    assert ck.path_for(cu) == 3
    x = torch.randn(4, 48_000, device=cuda_device)
    used = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    assert torch.equal(ck.ct_mel(x, cu, used), ck.ct_mel(x, cu))


def _launch_counts():
    return (nl.nemo_prologue.launches, ck.ct_mel.launches, ck.path_counts()[1],
            nl.nemo_finish.launches)


@pytest.mark.cuda
def test_the_direct_launcher_is_the_three_wrappers_on_card(cuda_device):
    """``nemo_direct`` makes the launches of the prologue (with the frame
    counts), K2 on ragged rows and the finish, counted as theirs, and
    answers as they do bit for bit, leading dimensions kept."""
    cfg = PA._nemo_cfg(128)
    cu = cfg.replace(center=False)
    x, lens = _ragged(6, 48_000, 50, cuda_device)
    x, lens = x.reshape(2, 3, 48_000), lens.reshape(2, 3)
    before = _launch_counts()
    got, seq = nl.nemo_direct(x, lens, cu)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (1, 1, 1, 2)
    used = torch.empty_like(lens)
    want, want_seq = nl.nemo_finish(ck.ct_mel(nl.nemo_prologue(x, lens, cfg, used), cu, used),
                                    lens, HOP)
    assert tuple(got.shape) == (2, 3, 128, 301) and torch.equal(seq, want_seq)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
def test_nemo_call_is_the_prologue_k2_and_the_finish_on_card(graph_cache, n_mels):
    graphs = graph_cache
    x, lens = _ragged(64, 400_000, 46, torch.device("cuda"))
    cfg = PA._nemo_cfg(n_mels)
    assert PA._nemo_direct(cfg, x, torch.device("cuda"))
    P.log_mel_spectrogram_nemo(x, lens, n_mels=n_mels)  # K2's constants reach the card
    c0, paths0 = graphs.cache.captures, PA.paths.read()
    before = _launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, seq = P.log_mel_spectrogram_nemo(x, lens, n_mels=n_mels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launch_counts(), before)) == (1, 1, 1, 2)
    assert graphs.cache.captures == c0
    assert PA.paths.read()["direct"] - paths0["direct"] == 1
    assert got.is_cuda and got.is_contiguous() and got.dtype == torch.float32
    assert tuple(got.shape) == (64, n_mels, 2501) and seq.is_cuda and seq.dtype == torch.int64
    with graphs.disabled():  # the eager path: the twins around K2
        eager, eager_seq = P.log_mel_spectrogram_nemo(x, lens, n_mels=n_mels)
    assert torch.equal(seq, eager_seq) and _err(got, eager) <= FINISH_TOL
    rows = [0, 3, 5, 6, 63]
    plain, _ = PF.nemo_log_mel(x[rows].cpu(), lens[rows].cpu(), cfg)
    assert _err(got[rows], plain) <= PLAIN_TOL
    ref, ref_seq = nemo_ref.log_mel_spectrogram(x[rows].cpu().numpy(), lens[rows].cpu().numpy(),
                                                n_mels)
    assert torch.equal(seq[rows].cpu(), ref_seq) and _err(got[rows], ref) <= PLAIN_TOL


@pytest.mark.cuda
def test_nemo_call_launches_four_kernels_on_card(graph_cache):
    """Traced in a fresh process (``tests/test_torch_port_cuda.traced_call``),
    the lengths on the card as the cell passes them: the prologue, K2 (no
    staged reflection: the prologue writes the zero pad) and the finish's
    two kernels, and no other device work."""
    from tests.test_torch_port_cuda import traced_call

    _, lens = _ragged(8, 160_000, 47, torch.device("cuda"))
    got = traced_call("log_mel_spectrogram_nemo", (8, 160_000), {"lengths": lens.tolist()},
                      on_card=("lengths",))
    kernels = got["device"]
    assert (got["reflect"], got["direct"]) == (0, 2)
    assert len(kernels) == 4, kernels
    assert [sum(k in n for n in kernels) for k in ("nemo_prologue", "ct_mel", "nemo_finish")] == \
        [1, 1, 2], kernels


@pytest.mark.cuda
def test_host_lengths_whole_rows_and_gradients_on_card(graph_cache):
    x, lens = _ragged(4, 32_000, 48, torch.device("cuda"))
    got, seq = P.log_mel_spectrogram_nemo(x, lens)
    for host in (lens.tolist(), lens.cpu().numpy(), lens.cpu()):
        g, s = P.log_mel_spectrogram_nemo(x, host)
        assert torch.equal(g, got) and torch.equal(s, seq)
    with pytest.raises(TypeError):  # the lengths are data: no default
        P.log_mel_spectrogram_nemo(x)
    full = torch.full((4,), 32_000, device="cuda")
    whole, whole_seq = P.log_mel_spectrogram_nemo(x, full)
    plain, _ = P.log_mel_spectrogram_nemo(x.cpu(), full.cpu(), device="cpu")
    assert whole_seq.tolist() == [201] * 4 and _err(whole.cpu(), plain) <= PLAIN_TOL
    a = x.clone().requires_grad_(True)
    before = PA.paths.read()["eager"]
    out, _ = P.log_mel_spectrogram_nemo(a, lens)
    assert PA.paths.read()["eager"] == before + 1 and _err(out.detach(), got) <= FINISH_TOL
    (out * torch.linspace(0, 1, out.shape[-1], device="cuda")).sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad[3:]).all())
