"""Host-side pieces of the FFT form of the fused speechpy-MFCC kernel
(``mfcc_rust_tpu_torch/ops/cuda/speechpy_mfcc.cu``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``).
Here: the path and stage plan the kernel's host code picks, its constants
(twiddle table, packed fb/n, ranges, DCT), numpy mirrors of its device index
algebra (the register passes of path 1, the Stockham stages of
``fft_stages.cuh``, the cp.async staging of a tile) against ``np.fft``, and a
float64 emulation of the FFT form of the whole function against the plain
version ``mfcc_fused_plain`` at max|Δ|/max|ref| <= 1e-5 (float32 plain code
against float64)."""

import dataclasses

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.constants import constant_bundle
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as pk

# the configs of tests/test_torch_port_kernel.py
CONFIGS = [
    ("default 20/10", {}, (2, 8000)),
    ("25/10 r=3", {"frame_length": 0.025}, (2, 8000)),
    ("preemph 0.97", {"preemphasis_cof": 0.97}, (2, 8000)),
    ("no dc_elim", {"dc_elimination": False}, (2, 8000)),
    ("r=1 10/10", {"frame_length": 0.01}, (2, 8000)),
    ("batched 3-D", {}, (2, 2, 4000)),
    ("T < fl", {}, (300,)),
]
MORE = [
    ("fft 400, path 2", {"fft_points": 400, "frame_length": 0.025}, (2, 8000)),
    ("fft 1024", {"fft_points": 1024}, (2, 8000)),
    ("fft 256", {"fft_points": 256, "frame_length": 0.016}, (2, 8000)),
    ("T no multiple of hop or 4", {}, (2, 7999)),
]


def _cfg(n: int):
    """A speechpy config at fft n with frames of min(320, n) samples and a
    hop of at most half a frame (16 kHz)."""
    fl = min(320, n)
    hop = min(160, max(fl // 2, 1))
    return P.speechpy_config(16000, fft_points=n, frame_length=fl / 16000,
                             frame_stride=hop / 16000)


def test_stage_plan_and_path_for_every_even_fft_size():
    """For every even n from 64 to 1024 the predicate takes: the radices
    multiply to n/2, path 1 (radices 8, 8, n/128) is picked exactly when n/2
    is a power of two from 64 to 512, and path 2 runs radix 4s, at most one
    2, then the odd part."""
    seen = set()
    for n in range(64, 1025, 2):
        cfg = _cfg(n)
        assert (cfg.frame_size, cfg.fft_points) == (min(320, n), n)
        assert pk.mfcc_kernel_supported(cfg), n
        plan = pk.stage_plan(n)
        assert int(np.prod(plan)) == n // 2, (n, plan)
        nc = n // 2
        path1 = nc in (64, 128, 256, 512)
        assert pk.fft_path(n) == (1 if path1 else 2), n
        if path1:
            assert plan[:2] == (8, 8) and all(r in (2, 4, 8) for r in plan), (n, plan)
        else:
            odd = [r for r in plan if r not in (2, 4)]
            assert len(odd) <= 1 and all(r % 2 for r in odd) and plan.count(2) <= 1, (n, plan)
            assert list(plan) == sorted(plan, key=lambda r: (r % 2, -r)), (n, plan)
        seen.add(pk.fft_path(n))
    assert seen == {1, 2}
    assert pk.stage_plan(512) == (8, 8, 4) and pk.stage_plan(400) == (4, 2, 25)


@pytest.mark.parametrize("n", [128, 256, 400, 512, 1024, 2048])
def test_twiddle_table_is_exp_minus_2pi_ik_over_n(n):
    tw, _, _, _, _ = pk._kernel_constants(_cfg(n))
    k = np.arange(n)
    assert tw.dtype == np.float32 and tw.shape == (n, 2)
    w = np.exp(-2j * np.pi * k / n)
    assert np.array_equal(tw[:, 0], w.real.astype(np.float32))
    assert np.array_equal(tw[:, 1], (-w.imag).astype(np.float32))


def _pcfg(kw):
    return P.from_reference(dataclasses.asdict(m.speechpy_config(16000, **kw)))


@pytest.mark.parametrize("name,kw,shape", CONFIGS + MORE[:2], ids=[c[0] for c in CONFIGS + MORE[:2]])
def test_packed_weights_rebuild_the_projection(name, kw, shape):
    cfg = _pcfg(kw)
    _, wpack, ranges, dct, kmax = pk._kernel_constants(cfg)
    mm = cfg.num_filters
    dense = np.zeros((mm, kmax), np.float32)
    for i, (lo, hi, off) in enumerate(ranges):
        assert 0 <= lo <= hi <= kmax
        dense[i, lo:hi] = wpack[off:off + hi - lo]
    assert np.array_equal(dense.T, PF._projection(cfg)[:kmax, :mm].astype(np.float32)), name
    assert kmax == constant_bundle(cfg)["fbank_kmax"] <= cfg.fft_points // 2 + 1
    assert np.array_equal(dct, constant_bundle(cfg)["dct"].astype(np.float32))
    # a bin feeds at most two speechpy filters
    assert ((dense != 0).sum(axis=0) <= 2).all()


def _dft(v):
    """dft<R> of speechpy_mfcc.cu, R = 2, 4 or 8, natural order."""
    if len(v) == 2:
        return np.array([v[0] + v[1], v[0] - v[1]])
    if len(v) == 4:
        s0, d0, s1, d1 = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        return np.array([s0 + s1, d0 - 1j * d1, s0 - s1, d0 + 1j * d1])
    e, o = _dft(v[0::2]), _dft(v[1::2])
    c = np.sqrt(0.5)
    o = np.array([o[0], complex((o[1].real + o[1].imag) * c, (o[1].imag - o[1].real) * c),
                  complex(o[2].imag, -o[2].real),
                  complex((o[3].imag - o[3].real) * c, -(o[3].real + o[3].imag) * c)])
    return np.concatenate([e + o, e - o])


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pad8(i):
    return i + (i >> 3)


def _path1_fft(z):
    """The passes of fft_regs<NC>: lane lt holds point lt + TPF*q, runs
    butterflies lt + TPF*u, writes Stockham places into a pad8 buffer and
    gathers its points back."""
    nc = z.size
    n = 2 * nc
    tpf = min(32, nc // 8)
    p = nc // tpf
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    a = np.array([[z[lt + tpf * q] for q in range(p)] for lt in range(tpf)])
    ns = 1
    for r in pk.stage_plan(n):
        u_n, step = p // r, 2 * nc // (ns * r)
        buf = np.full(_pad8(nc), np.nan, complex)
        for lt in range(tpf):
            for u in range(u_n):
                b = lt + tpf * u
                k = b & (ns - 1)
                v = np.array([a[lt, u + q * u_n] for q in range(r)])
                if ns > 1:
                    v = v * tw[[k * q * step for q in range(r)]]
                base = (b - k) * r + k
                for rr, val in enumerate(_dft(v)):
                    i = _pad8(base + rr * ns)
                    assert np.isnan(buf[i])  # each place written once
                    buf[i] = val
        ns *= r
        a = np.array([[buf[_pad8(lt + tpf * q)] for q in range(p)] for lt in range(tpf)])
    return np.array([buf[_pad8(i)] for i in range(nc)])


def _stockham(z):
    """fft::stockham of fft_stages.cuh (a loop over lt stands for the lanes)."""
    nc = z.size
    n = 2 * nc
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    m_odd, n4, has2 = pk.fft_plan(n)
    bufs = [z.astype(complex), np.zeros(nc, complex)]
    src, lg = 0, 0
    for _ in range(n4):
        q4, step = nc // 4, 2 * (nc // (4 << lg))
        i, o = bufs[src], bufs[src ^ 1]
        for j in range(q4):
            k = j & ((1 << lg) - 1)
            a = [i[j + q * q4] * (tw[q * k * step] if k else 1) for q in range(4)]
            base = ((j >> lg) << (lg + 2)) + k
            for r, val in enumerate(_dft(np.array(a))):
                o[base + (r << lg)] = val
        src ^= 1
        lg += 2
    if has2:
        h, step = nc // 2, 2 * (nc // (2 << lg))
        i, o = bufs[src], bufs[src ^ 1]
        for j in range(h):
            k = j & ((1 << lg) - 1)
            a0, a1 = i[j], i[j + h] * (tw[k * step] if k else 1)
            base = ((j >> lg) << (lg + 1)) + k
            o[base], o[base + (1 << lg)] = a0 + a1, a0 - a1
        src ^= 1
        lg += 1
    if m_odd > 1:
        ns = 1 << lg
        i, o = bufs[src], bufs[src ^ 1]
        for it in range(nc):
            j, r = divmod(it, m_odd)
            o[j + r * ns] = sum(i[j + q * ns] * tw[(2 * q * (j + r * ns)) % n]
                                for q in range(m_odd))
        src ^= 1
    return bufs[src]


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 400, 200, 2048, 96])
def test_device_fft_index_algebra_matches_numpy(n):
    z = np.random.default_rng(n).normal(size=n // 2) + 1j * np.random.default_rng(n + 1).normal(
        size=n // 2)
    want = np.fft.fft(z)
    got = _path1_fft(z) if pk.fft_path(n) == 1 else _stockham(z)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    if pk.fft_path(n) == 1:  # path 2's stages serve any power of two too
        np.testing.assert_allclose(_stockham(z), want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("head", [0, 1, 2, 3])
@pytest.mark.parametrize("avail,length", [(5280, 5280), (1000, 5280), (3, 5280), (7, 7), (2, 2)])
def test_tile_staging_covers_each_sample_once(head, avail, length):
    """stage_tile: 4-byte copies up to the first 16-byte boundary, 16-byte
    copies with both addresses aligned, 4-byte copies for the tail, zeros
    past the row's end; sample i lands in slot head + i."""
    pre = min((4 - head) & 3, avail)
    n16 = (avail - pre) // 4
    tail = pre + 4 * n16
    slot = np.full(head + length, -1)
    for i in range(pre):
        slot[head + i] = i
    for v in range(n16):
        d = head + pre + 4 * v
        assert d % 4 == 0  # the shared slot, and so the sample's address (same head)
        slot[d:d + 4] = np.arange(pre + 4 * v, pre + 4 * v + 4)
    for i in range(tail, avail):
        slot[head + i] = i
    zeros = head + np.arange(avail, length)
    slot[zeros] = -2
    assert (slot[head:head + avail] == np.arange(avail)).all()
    assert (slot[head + avail:] == -2).all()


def _fft_form(x, cfg):
    """float64 numpy of the kernel's function: frames of fl samples zero-
    padded to n, the complex FFT of n/2 points and the real split (held to
    np.fft.rfft), the packed projection of the kmax bins, Parseval energy
    from X_0 and X_{n/2}, f32 eps, log, the DCT."""
    n, hop, fl = cfg.fft_points, cfg.frame_step, cfg.frame_size
    tw, wpack, ranges, _, kmax = pk._kernel_constants(cfg)
    eps = float(np.finfo(np.float32).eps)
    lead, t = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, t)
    count = max((t - fl) // hop, 0)
    frames = np.zeros((x.shape[0], count, n))
    for f in range(count):
        frames[:, f, :fl] = x[:, f * hop: f * hop + fl]
    z = np.fft.fft(frames[..., 0::2] + 1j * frames[..., 1::2], axis=-1)
    k = np.arange(kmax)
    zk, zm = z[..., k % (n // 2)], np.conj(z[..., (n // 2 - k) % (n // 2)])
    w = tw[:kmax, 0].astype(np.float64) - 1j * tw[:kmax, 1].astype(np.float64)
    spec = 0.5 * (zk + zm) - 0.5j * (zk - zm) * w
    np.testing.assert_allclose(spec, np.fft.rfft(frames, axis=-1)[..., :kmax],
                               rtol=0, atol=1e-6 * max(np.abs(spec).max(initial=0), 1))
    pw = np.abs(spec) ** 2
    mel = np.stack([pw[..., lo:hi] @ wpack[off:off + hi - lo].astype(np.float64)
                    for lo, hi, off in ranges], axis=-1)
    out = np.log(np.where(mel == 0, eps, mel)) @ constant_bundle(cfg)["dct"]
    if cfg.dc_elimination:
        x0, xn = z[..., 0].real + z[..., 0].imag, z[..., 0].real - z[..., 0].imag
        en = (n * (frames[..., :fl] ** 2).sum(-1) + x0 ** 2 + xn ** 2) / (2 * n)
        out[..., 0] = np.log(np.where(en == 0, eps, en))
    return out.reshape(lead + out.shape[1:])


@pytest.mark.parametrize("name,kw,shape", CONFIGS + MORE, ids=[c[0] for c in CONFIGS + MORE])
def test_fft_form_matches_plain(name, kw, shape):
    cfg = _pcfg(kw)
    x = np.random.default_rng(19).normal(0, 0.1, shape).astype(np.float32)
    px = torch.from_numpy(x)
    if cfg.preemphasis_cof:
        px = pframing.preemphasis(px, 1, cfg.preemphasis_cof)
    plain = pk.mfcc_fused_plain(px, cfg)
    assert rel(_fft_form(px.numpy().astype(np.float64), cfg), plain) <= 1e-5, name


def test_supported_set_unchanged_and_default_block_is_eight_warps():
    """The new shared-memory clause takes what the old one took here (the
    JAX predicate's configs plus 128 mels and fft 2048 on the matmul DFT)
    and refuses a tile that cannot fit; the headline block of eight warps
    leaves room for two blocks an SM."""
    for kw in ({}, {"frame_length": 0.025}, {"frame_length": 0.01}, {"num_filters": 128},
               {"fft_points": 1024, "num_filters": 26}, {"fft_points": 400, "frame_length": 0.025},
               {"fft_points": 2048, "fft_impl": "matmul"}):
        assert pk.mfcc_kernel_supported(_pcfg(kw)), kw
    assert not pk.mfcc_kernel_supported(P.speechpy_config(
        16000, fft_points=4096, frame_length=0.2, frame_stride=0.1, fft_impl="matmul"))
    cfg = P.speechpy_config(16000)
    _, wpack, _, _, kmax = pk._kernel_constants(cfg)
    assert (kmax, wpack.size) == (129, 210)  # 420 in the cos and sin rows of proj
    assert pk.smem_bytes(512, 160, 320, kmax, wpack.size, 40, 8) <= 232448 // 2
