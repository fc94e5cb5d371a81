"""Whisper's log-mel front end on the card: the finish kernels
(``ops/cuda/whisper_logmel.cu``) against their plain twin, K2's plan at
n_fft 400 (path 3, the 8 x 25 register FFT) and K2 there against its plain
version, and ``api.log_mel_spectrogram_whisper``'s direct path.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX:

    python -m pytest tests/test_torch_port_whisper_cuda.py -m cuda --noconftest -q

Tolerance of the kernels against their plain twin on the same power: 2e-6
in max|Δ| of Whisper's output units ((log10 + 4) / 4, |value| <= 2.75
where the power is at most 1e3): the card's ``log10f`` and the plain
version's log10 may differ by an ulp or two of the log, and the rest is the
same float32 arithmetic in the same order.  The API answer against the
plain path on the CPU and against the float64 reference
(``tests/golden/whisper_ref.py``): the CPU tests' 5e-4 at 128 mels (the
plain path's float32 DFT product).  K2 against ``ct_mel_plain``:
max|Δ|/max|ref| <= 1e-4, the tolerance its path-2 cases have in
``tests/test_torch_port_cuda.py`` (an FFT against the plain version's
factored product, both float32)."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck
from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as wl
from tests.golden import whisper_ref

KERNEL_TOL = 2e-6
PLAIN_TOL = 5e-4
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
    if ref.numel() == 0:
        return 0.0
    assert torch.equal(torch.isnan(a), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    return (a[ok] - ref[ok]).abs().max().item() if bool(ok.any()) else 0.0


def _power(shape, seed, device, offset=0):
    """Mel powers of the given (..., F, M) shape: exponential noise over six
    decades, a silent stretch in each row's second half, and one row 1e-4
    quieter; ``offset`` floats into a buffer, to misalign the rows."""
    g = torch.Generator().manual_seed(seed)
    p = torch.empty(shape).exponential_(generator=g) * 10 ** (6 * torch.rand(shape, generator=g) - 4)
    f = shape[-2]
    p[..., f // 2: f // 2 + max(f // 8, 1), :] = 0.0
    if p.dim() > 2 and p.shape[0] > 1:
        p[1] *= 1e-4
    buf = torch.empty(p.numel() + offset, device=device)
    out = buf[offset:].view(shape)
    out.copy_(p)
    return out


# (name, power shape, offset): the cell's shape, 80 mels, a 3-D batch, one
# kept frame, no kept frame, mels that are no multiple of 4, misaligned rows
FINISH = [("cell 64x3001x128", (64, 3001, 128), 0), ("80 mels", (3, 1001, 80), 0),
          ("3-D", (2, 3, 257, 128), 0), ("one kept frame", (2, 2, 128), 0),
          ("no kept frame", (2, 1, 80), 0), ("83 mels", (2, 700, 83), 0),
          ("misaligned", (2, 700, 128), 1), ("long row", (1, 90_001, 128), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,offset", FINISH, ids=[c[0] for c in FINISH])
def test_finish_kernel_matches_its_plain_twin_on_card(cuda_device, name, shape, offset):
    p = _power(shape, 23, cuda_device, offset)
    before = wl.whisper_logmel.launches
    got = wl.whisper_logmel(p)
    torch.cuda.synchronize()
    want = wl.whisper_logmel_plain(p)
    kept = shape[-2] - 1
    assert got.is_cuda and got.is_contiguous() and got.dtype == torch.float32
    assert tuple(got.shape) == shape[:-2] + (shape[-1], kept)
    assert wl.whisper_logmel.launches - before == (2 if kept else 0)
    assert _err(got, want) <= KERNEL_TOL, name


@pytest.mark.cuda
def test_finish_kernel_keeps_nan_where_the_plain_twin_does_on_card(cuda_device):
    p = _power((3, 500, 128), 24, cuda_device)
    p[1, 7, 9] = float("nan")
    p[2, -1, 0] = float("nan")  # in the dropped frame: no effect
    got = wl.whisper_logmel(p)
    want = wl.whisper_logmel_plain(p)
    assert bool(torch.isnan(got[1]).all()) and not bool(torch.isnan(got[2]).any())
    assert _err(got, want) <= KERNEL_TOL


@pytest.mark.cuda
def test_k2_takes_path_3_at_n_fft_400_on_card(cuda_device):
    for n_mels in (80, 128):
        cfg = PA._whisper_cfg(n_mels)
        _, _, wpack, _, kmax = ck._kernel_constants(cfg)
        args = (400, 160, kmax, wpack.size, n_mels)
        plan = ck.launch_plan(cfg, 64, 3001)
        assert plan["path"] == 3 and plan["warps"] == ck.fft_warps(*args) == 8, plan
        assert plan["smem_bytes"] == ck.fft_smem_bytes(*args, 8), plan
        assert plan["blocks_per_sm"] >= 1 and 1 <= plan["grid"] <= 64 * 94, plan


def _rel(a, ref):
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return (a - ref).abs().max().item() / ref.abs().max().item() if ref.numel() else 0.0


# (name, rows, samples, n_mels): the cell's shape, 3 rows, a frame count
# that is no multiple of the 32-frame tile, a row shorter than one tile,
# an odd row length, 80 mels
K2_SHAPES = [("cell 64x480000", 64, 480_000, 128), ("3 rows", 3, 48_000, 128),
             ("ragged tile", 2, 160 * 45 + 77, 128), ("short row", 1, 160 * 9, 128),
             ("odd length", 2, 16_001, 80), ("80 mels", 5, 32_000, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows,samples,n_mels", K2_SHAPES, ids=[c[0] for c in K2_SHAPES])
def test_k2_path_3_matches_plain_on_card(cuda_device, name, rows, samples, n_mels):
    """K2 on path 3 against ``ct_mel_plain`` on the centre-padded rows, every
    frame of zeros computed: rows of noise that end in zeros, one launch,
    counted on path 3."""
    cfg = PA._whisper_cfg(n_mels)
    x = np.random.default_rng(29).normal(0, 0.1, (rows, samples)).astype(np.float32)
    x[:, samples // 2:] = 0.0
    xd = torch.from_numpy(x).to(cuda_device)
    before, paths = ck.ct_mel.launches, ck.path_counts()
    got = ck.ct_mel(xd, cfg)
    torch.cuda.synchronize()
    assert ck.ct_mel.launches - before == 1
    after = ck.path_counts()
    assert {p: after[p] - paths[p] for p in after} == {1: 0, 2: 0, 3: 1}
    assert tuple(got.shape) == (rows, 1 + samples // 160, n_mels)
    assert _rel(got, ck.ct_mel_plain(xd, cfg)) <= K2_TOL, name


def _launch_counts():
    return ck.ct_mel.launches, wl.whisper_logmel.launches, ck.path_counts()[3]


@pytest.mark.cuda
@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_call_is_the_pad_k2_and_the_finish_in_place_on_card(graph_cache, n_mels):
    graphs = graph_cache
    x = torch.from_numpy(np.random.default_rng(25).normal(0, 0.1, (64, 480_000))
                         .astype(np.float32)).cuda()
    x[1:, 96_000:] = 0.0
    cfg = PA._whisper_cfg(n_mels)
    assert PA._k2_alone(cfg, x, torch.device("cuda"))
    c0, r0, paths0 = graphs.cache.captures, graphs.cache.replays, PA.paths.read()
    before = _launch_counts()
    got = P.log_mel_spectrogram_whisper(x, n_mels=n_mels)
    torch.cuda.synchronize()
    k2, fin, path3 = (a - b for a, b in zip(_launch_counts(), before))
    assert (k2, fin, path3) == (1, 2, 1)
    assert (graphs.cache.captures - c0, graphs.cache.replays - r0) == (0, 0)
    assert PA.paths.read()["direct"] - paths0["direct"] == 1
    assert got.is_cuda and got.is_contiguous() and got.dtype == torch.float32
    assert tuple(got.shape) == (64, n_mels, 3000)
    with graphs.disabled():  # the eager path: K2, then the plain finish
        eager = P.log_mel_spectrogram_whisper(x, n_mels=n_mels)
    assert _err(got, eager) <= KERNEL_TOL
    rows = [0, 1, 63]
    plain = PF.whisper_log_mel(x[rows].cpu(), cfg)
    assert _err(got[rows], plain) <= PLAIN_TOL
    assert _err(got[rows], whisper_ref.log_mel_spectrogram(x[rows].cpu(), n_mels)) <= PLAIN_TOL


@pytest.mark.cuda
def test_whisper_call_launches_at_most_four_kernels_on_card(cuda_device):
    """The direct Whisper call is K2, which stages the centre pad's
    reflection itself, and the finish's two kernels: no
    ``reflection_pad1d``, one staged reflection a call (traced in a fresh
    process, ``tests/test_torch_port_cuda.traced_call``)."""
    from tests.test_torch_port_cuda import traced_call

    got = traced_call("log_mel_spectrogram_whisper", (8, 480_000), {"n_mels": 128})
    kernels = got["device"]
    assert 0 < len(kernels) <= 4, kernels
    assert sum("ct_mel" in k for k in kernels) == 1, kernels
    assert sum("whisper_logmel" in k for k in kernels) == 2, kernels
    assert not any("reflection_pad" in k for k in kernels + got["host"]), got
    assert (got["reflect"], got["direct"]) == (2, 2)


@pytest.mark.cuda
def test_padding_short_clips_and_gradients_on_card(graph_cache):
    rng = np.random.default_rng(27)
    x = torch.from_numpy(rng.normal(0, 0.1, (2, 32_000)).astype(np.float32)).cuda()
    got = P.log_mel_spectrogram_whisper(x, padding=8_000)
    want = P.log_mel_spectrogram_whisper(torch.nn.functional.pad(x, (0, 8_000)))
    assert tuple(got.shape) == (2, 80, 250) and torch.equal(got, want)
    short = x[:, :150]  # the pad folds: the graphed path, K2 and the plain finish
    before = PA.paths.read()["graphed"]
    s = P.log_mel_spectrogram_whisper(short)
    assert PA.paths.read()["graphed"] == before + 1 and tuple(s.shape) == (2, 80, 0)
    mid = x[:, :320]
    m = P.log_mel_spectrogram_whisper(mid)
    assert _err(m, PF.whisper_log_mel(mid.cpu(), PA._whisper_cfg(80))) <= PLAIN_TOL
    a = x.clone().requires_grad_(True)
    P.log_mel_spectrogram_whisper(a).sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())


@pytest.mark.cuda
def test_graph_replay_counts_the_finish_launches_on_card(graph_cache):
    """A graph that holds the finish kernel (the kernel called inside a
    capture) re-adds its two launches per replay."""
    graphs = graph_cache
    p = _power((4, 300, 128), 28, torch.device("cuda"))
    before = wl.whisper_logmel.launches
    outs = [graphs.cache.run(("whisper finish",), wl.whisper_logmel, p.shape, p.dtype,
                             p.device, lambda s: s.copy_(p)) for _ in range(3)]
    torch.cuda.synchronize()
    assert wl.whisper_logmel.launches - before == 6
    for out in outs:
        assert _err(out, wl.whisper_logmel_plain(p)) <= KERNEL_TOL
