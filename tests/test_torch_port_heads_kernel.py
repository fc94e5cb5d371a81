"""The speechpy heads kernel (``ops/cuda/speechpy_heads.cu``) of
``features._extract_heads``: where it dispatches, on the CPU, and, on the
card, its heads against the plain version (``_extract_heads_plain``) of the
same product.

The file imports no JAX.  Its card tests are marked ``cuda`` and skip
without a CUDA device:

    python -m pytest tests/test_torch_port_heads_kernel.py -m cuda --noconftest -q

Tolerances, in the suite cell's own numbers (``benchmark/limits/``, where
``mfe`` and ``energy`` take max|Δ|/(|ref| + 0.02 max|ref|) and the others
max|Δ|/max|ref|): 1e-5 for ``mfe``, ``energy`` and ``ssc``, 3e-5 for the
logs (``lmfe``, ``mfcc``), as ``test_torch_port_extract.py`` holds two
float32 programs that sum in different orders; each is at most the cell's
limit (1e-4, 1e-5, 1e-5, 1e-3, 1e-3)."""

import functools
import itertools

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import framing
from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ke
from mfcc_rust_tpu_torch.ops.cuda import speechpy_heads as kh

# head -> (tolerance, the cell's comparison)
TOL = {"mfe": (1e-5, "mixed"), "energy": (1e-5, "mixed"), "ssc": (1e-5, "rel"),
       "lmfe": (3e-5, "rel"), "mfcc": (3e-5, "rel")}
SUBSETS = [s for n in range(1, len(PF.EXTRACT_HEADS) + 1)
           for s in itertools.combinations(PF.EXTRACT_HEADS, n)]


def _leaves(out: dict) -> dict:
    """name -> tensor, ``mfe`` split into its features and energies."""
    flat = {}
    for name, v in out.items():
        if name == "mfe":
            flat["mfe"], flat["mfe.energy"] = v
        else:
            flat[name] = v
    return flat


def rel(a, ref, kind: str = "rel") -> float:
    """max|a - ref| / max|ref|, or with ``kind="mixed"`` the largest
    |a - ref| / (|ref| + 0.02 max|ref|)."""
    a, ref = a.detach().double().cpu(), ref.detach().double().cpu()
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.numel() == 0:
        return 0.0
    top = ref.abs().max()
    if kind == "mixed":
        return ((a - ref).abs() / (ref.abs() + 0.02 * top)).max().item()
    return ((a - ref).abs().max() / top).item()


def within(got: dict, ref: dict) -> None:
    """Every head of ``got`` within its tolerance of ``ref``'s, and
    non-finite exactly where ``ref``'s is: the SSC of a filter with no
    nonzero bin (some of 128 filters over 257 bins) is 0/0, as speechpy's."""
    g, r = _leaves(got), _leaves(ref)
    assert g.keys() == r.keys()
    for name in r:
        tol, kind = TOL[name.split(".")[-1]]
        a, b = g[name].detach().cpu(), r[name].detach().cpu()
        assert a.shape == b.shape, name
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), (name, "non-finite elsewhere")
        err = rel(a[finite], b[finite], kind)
        assert err <= tol, (name, err, tol)


# ------------------------------------------------------ dispatch (CPU) --
GUARD = ["card", "cpu", "autograd", "trace", "pallas off"]


@pytest.mark.parametrize("case", GUARD)
def test_heads_take_the_kernel_only_where_the_guard_holds(monkeypatch, case):
    """The card is stubbed: ``_on_card`` reads True (but in the "cpu"
    case), and the two kernels' launches are stubs that count their calls
    and compute what the plain versions do.  Only the "card" case launches
    the heads (and the edge sums); the CPU, a recorded gradient, a trace
    and ``pallas="off"`` take the plain heads.  Every case's heads equal
    the plain path's bit for bit."""
    calls = {"edges": 0, "heads": 0}

    def edge_sums(x, y, cfg, n):
        calls["edges"] += 1
        ch, _ = PF._chunk_gemm(x, PF._speechpy_tensors(cfg, x.device, x.dtype)["wall"], n,
                               cfg.frame_step)
        return PF._exact_edges_plain(ch, y, cfg, n)

    def heads(ch, y, cfg, want, n, need_energy):
        calls["heads"] += 1
        c = PF._speechpy_tensors(cfg, y.device, y.dtype)
        return PF._extract_heads_plain(ch, y, c, cfg, want, n, need_energy)

    monkeypatch.setattr(ke, "edge_sums", edge_sums)
    monkeypatch.setattr(kh, "heads", heads)
    if case != "cpu":
        monkeypatch.setattr(PF, "_on_card", lambda t: True)
    cfg = P.speechpy_config(16000)
    which = ("mfe", "lmfe", "ssc", "mfcc", "energy")
    x = torch.from_numpy(np.random.default_rng(22).normal(0, 0.1, (2, 4000)).astype(np.float32))
    want = PF.extract(x, cfg.replace(pallas="off"), which)
    if case == "trace":
        got = make_fx(lambda s: PF.extract(s, cfg, which), tracing_mode="fake")(x)(x)
    elif case == "autograd":
        got = PF.extract(x.clone().requires_grad_(True), cfg, which)
    else:
        got = PF.extract(x, cfg.replace(pallas="off") if case == "pallas off" else cfg, which)
    n = 1 if case == "card" else 0
    assert calls == {"edges": n, "heads": n}, case
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in w:
        assert torch.equal(g[name].detach(), w[name]), (case, name)


# (name, speechpy_config keywords at 16 kHz) of fast-path configs past the
# defaults that the kernel takes: a zero tail in the window weights (25 ms
# frames, r = 3), weights other than 1 (hann), blocks past 48 KB of shared
# memory (fft 1024 and 2048, 128 filters and 40 cepstra), a pre-emphasised
# signal, and rows of W % 4 != 0 (a 4 kHz top band: kmax 64, W 130), which
# the kernel stages a float at a time
CONFIGS = [
    ("25 ms frames", {"frame_length": 0.025}),
    ("hann", {"window": "hann"}),
    ("fft 1024", {"fft_points": 1024}),
    ("fft 2048", {"fft_points": 2048, "fft_impl": "matmul"}),
    ("128 filters", {"num_filters": 128, "num_cepstral": 40}),
    ("preemphasis", {"preemphasis_cof": 0.97}),
    ("4 kHz band", {"high_frequency": 4000}),
]
# the configs with filters of no nonzero bin, whose SSC is 0/0 there
NAN_SSC = ("128 filters", "4 kHz band")


def test_heads_kernel_takes_every_fast_path_config_that_fits():
    """``heads_kernel_supported``: a chunk-GEMM config whose block fits in
    shared memory; the mirror of the .cu's layout at speechpy's defaults."""
    cfg = P.speechpy_config(16000)
    assert kh.heads_kernel_supported(cfg)
    consts, sched, kmax, nnz = kh._kernel_constants(cfg)
    assert (kmax, nnz, consts.size, sched.shape) == (129, 210, 3 * 210 + 40 * 13 + 320, (40, 4))
    assert kh.smem_bytes(2 * kmax + 2, nnz, 40, 13, 320) == 44_928
    for name, kw in CONFIGS:
        assert kh.heads_kernel_supported(P.speechpy_config(16000, **kw)), name
    # a block past shared memory: fft 4096 (kmax 1025), 4 rows of 2,052 floats a warp
    big = P.speechpy_config(16000, fft_points=4096, fft_impl="matmul")
    assert PF._fast_path_ok(big) and not kh.heads_kernel_supported(big)


def test_band_schedule_evens_the_bins_a_lane_sums():
    """Every band once; lane l takes the bands at l, l + 32, ...: at
    speechpy's 40 bands (1 to 16 bins) no lane sums more than the widest
    band's 16 bins, and the warp's two passes take 16 + 1 bin steps, where
    the bands in their own order take 9 + 16."""
    cfg = P.speechpy_config(16000)
    ranges = kh.pack_filterbank(PF._projection(cfg)[:129, :40].T)[1]
    sched = kh.band_schedule(ranges)
    assert sorted(sched[:, 3]) == list(range(40))
    assert (sched[:, :3] == ranges[sched[:, 3]]).all()
    width = sched[:, 1] - sched[:, 0]
    assert max(width[lane::32].sum() for lane in range(32)) == width.max() == 16
    steps = lambda w: sum(w[i:i + 32].max() for i in range(0, len(w), 32))
    assert (steps(width), steps(ranges[:, 1] - ranges[:, 0])) == (17, 25)
    for m in (20, 64, 100, 128):  # any count of bands
        r = np.stack([np.zeros(m, int), np.arange(1, m + 1), np.zeros(m, int)], axis=1)
        assert sorted(kh.band_schedule(r)[:, 3]) == list(range(m))


# ---------------------------------------------------------- on the card --
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (name, input shape, zero the tail of row 0 and all of the last row)
SIGNALS = [
    ("suite cell", (64, 177_664), False),
    ("odd length", (3, 8_001), False),
    ("batch 1, short", (1, 1_000), False),
    ("zero tail and zero row", (4, 16_000), True),
]


# the configs of the card tests: speechpy's defaults, CONFIGS, and the
# defaults on a product that starts 4 bytes past a 16-byte boundary, which
# the kernel stages a float at a time
CARD_CONFIGS = dict([("defaults", {})] + CONFIGS + [("offset product", {})])


@functools.lru_cache(maxsize=8)
def _product(name: str, dc: bool, config: str = "defaults"):
    """(cfg, constants, chunks, product, frames) on the card, the
    product's X_0 and X_{N/2} exact."""
    _, shape, zeros = next(s for s in SIGNALS if s[0] == name)
    cfg = P.speechpy_config(16000, dc_elimination=dc, **CARD_CONFIGS[config])
    x = np.random.default_rng(23).normal(0, 0.1, shape).astype(np.float32)
    if zeros:
        x[0, shape[-1] // 2:] = 0.0  # the bucket's zero tail
        x[-1] = 0.0
    x = torch.from_numpy(x).cuda()
    if cfg.preemphasis_cof:
        x = framing.preemphasis(x, 1, cfg.preemphasis_cof)
    n = (shape[-1] - cfg.frame_size) // cfg.frame_step
    c = PF._speechpy_tensors(cfg, x.device, x.dtype)
    ch, y = PF._speechpy_product(x, c, cfg, n)
    if config == "offset product":
        y = torch.empty(y.numel() + 1, device=y.device)[1:].view(y.shape).copy_(y)
        assert y.data_ptr() % 16 == 4
    return cfg, c, ch, y, n


def _kernel_against_plain(which, dc, signal, config="defaults"):
    cfg, c, ch, y, n = _product(signal, dc, config)
    want = set(which)
    need_energy = bool(want & {"mfe", "energy"}) or ("mfcc" in want and cfg.dc_elimination)
    before = kh.heads.launches
    got = PF._extract_heads(ch, y, c, cfg, want, n, need_energy)
    torch.cuda.synchronize()
    assert kh.heads.launches == before + 1
    ref = PF._extract_heads_plain(ch, y, c, cfg, want, n, need_energy)
    assert all(t.is_cuda for t in _leaves(got).values())
    if config not in NAN_SSC:
        assert all(bool(torch.isfinite(t).all()) for t in _leaves(got).values())
    within(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("signal", [s[0] for s in SIGNALS])
@pytest.mark.parametrize("dc", [True, False], ids=["dc_elim", "no_dc_elim"])
@pytest.mark.parametrize("which", SUBSETS, ids=["+".join(s) for s in SUBSETS])
def test_heads_kernel_matches_plain_on_card(cuda_device, which, dc, signal):
    _kernel_against_plain(which, dc, signal)


# every head at once and each alone; the heads vary fastest, the config slowest
CONFIG_HEADS = [tuple(PF.EXTRACT_HEADS)] + [(h,) for h in PF.EXTRACT_HEADS]


@pytest.mark.cuda
@pytest.mark.parametrize("which", CONFIG_HEADS, ids=["+".join(s) for s in CONFIG_HEADS])
@pytest.mark.parametrize("signal", [s[0] for s in SIGNALS])
@pytest.mark.parametrize("dc", [True, False], ids=["dc_elim", "no_dc_elim"])
@pytest.mark.parametrize("config", [c for c in CARD_CONFIGS if c != "defaults"])
def test_heads_kernel_matches_plain_across_configs_on_card(cuda_device, config, dc, signal,
                                                           which):
    _kernel_against_plain(which, dc, signal, config)


@pytest.mark.cuda
def test_extract_takes_the_heads_kernel_unless_asked_not_to_on_card(cuda_device):
    cfg = P.speechpy_config(16000)
    x = torch.from_numpy(np.random.default_rng(24).normal(0, 0.1, (4, 16000)).astype(np.float32))
    heads = ("mfe", "lmfe", "ssc", "mfcc")
    before = kh.heads.launches
    got = PF.extract(x.cuda(), cfg, heads)
    assert kh.heads.launches == before + 1
    plain = PF.extract(x.cuda(), cfg.replace(pallas="off"), heads)
    cpu = PF.extract(x, cfg, heads)
    a = x.cuda().requires_grad_(True)  # a gradient takes the plain heads
    PF.extract(a, cfg, ("mfcc",))["mfcc"].sum().backward()
    assert kh.heads.launches == before + 1 and torch.isfinite(a.grad).all()
    within(got, plain)
    within(got, cpu)


@pytest.mark.cuda
def test_replayed_extract_counts_one_heads_launch_a_replay_on_card(cuda_device):
    """``api.extract`` replays its CUDA graph after the first call, and each
    replay counts one launch of the heads kernel, as of the edge kernel."""
    x = torch.from_numpy(np.random.default_rng(25).normal(0, 0.1, (4, 16000)).astype(np.float32))
    x = x.cuda()
    heads = ("mfe", "lmfe", "ssc", "mfcc")
    first = P.extract(x, 16000, which=heads)
    kh.heads.launches = ke.edge_sums.launches = 0
    for _ in range(3):
        out = P.extract(x, 16000, which=heads)
    torch.cuda.synchronize()
    assert (kh.heads.launches, ke.edge_sums.launches) == (3, 3)
    g, r = _leaves(out), _leaves(first)
    for name in r:
        assert rel(g[name], r[name]) <= 1e-6, name
