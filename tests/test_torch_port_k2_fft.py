"""Host-side pieces of path 1 of the CT mel kernel
(``mfcc_rust_tpu_torch/ops/cuda/ct_mel.cu``: the warp-per-frame register
FFT of ``fft_regs.cuh`` over cp.async-staged tiles), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``).
Here: the path and launch-plan rule for every even n_fft, numpy mirrors of
the device index algebra (the passes, the padded exchanges, the radix-32
last pass with its product twiddles, the shuffle partner of the register
split, the staging of a tile and the even/odd frame starts) against
``np.fft``, and a float64 emulation of path 1's whole function against the
plain version ``ct_mel_plain`` at max|Δ|/max|ref| <= 1e-5 (float32 plain
code against float64), next to the JAX Pallas kernel ``ct_mel_pallas`` in
interpret mode (as ``tests/test_pallas.py`` runs it) at 1e-5.  Path 3 (n =
400, nc = 200 = 8 x 25, ``fft200`` of ``fft_regs.cuh``) likewise: its
lanes' points, the 5 x 5 DFT with the kernel's float32 constants, the
W_200 table indices, the three shuffle stages across 8 lanes, the split's
partner lane and register, the banks of the power buffers, its plan at
Whisper's hop and its whole function against ``ct_mel_plain`` (the JAX
kernel takes no n_fft 400)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu.ops.pallas import ct_mel as jk

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as pk

TILE_F = 16  # ct_mel.cu: kTileF


def _lanes(nc):
    """lanes_per_frame of fft_regs.cuh: the lanes of a path-1 frame."""
    return 32 if nc >= 256 else nc // 8


def _xpad(nc, i):
    """xpad of fft_regs.cuh, the exchange-buffer index: one float skipped
    every 32 at nc = 1024, every 8 below."""
    return i + (i >> 5) if nc == 1024 else i + (i >> 3)


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_path_and_plan_for_every_even_fft_size():
    """Path 1 exactly when n/2 is a power of two from 64 to 1024 (and the
    tile fits), with eight warps a block at the librosa hops; path 3 exactly
    at n = 400 (its tile fits), eight warps too; path 2 for every other even
    n, with G frames a block; a hop too long for path 1's or path 3's tile
    sends n to path 2."""
    seen = set()
    for n in range(64, 4097, 2):
        nc, kmax, m_ = n // 2, n // 2 + 1, 128
        nnz, hop = 2 * kmax, max(n // 4, 1)
        path = pk.fft_path(n, hop, kmax, nnz, m_)
        want = 1 if nc in (64, 128, 256, 512, 1024) else 3 if n == 400 else 2
        assert path == want, n
        if path in (1, 3):
            assert pk.fft_warps(n, hop, kmax, nnz, m_) == 8, n
            assert pk.fft_smem_bytes(n, hop, kmax, nnz, m_, 8) <= 232448, n
        else:
            assert pk.fft_warps(n, hop, kmax, nnz, m_) == 0, n
            g = pk.frames_per_block(n, nnz)
            assert 1 <= g <= 8 and pk.smem_bytes(n, g, nnz) <= 232448, n
        seen.add(path)
    assert seen == {1, 2, 3}
    assert pk.fft_path(2048, 8000, 1025, 2050, 128) == 2  # a slab of 122 k floats
    assert pk.fft_path(400, 2000, 201, 402, 128) == 2  # a path-3 slab of 62 k floats
    # the librosa headline: one block of eight warps, 163,248 bytes
    cfg = P.librosa_config(22050)
    _, _, wpack, _, kmax = pk._kernel_constants(cfg)
    assert (kmax, wpack.size, pk.path_for(cfg)) == (1024, 2018, 1)
    assert pk.fft_smem_bytes(2048, 512, kmax, wpack.size, 128, 8) == 163248
    assert pk.path_for(P.librosa_config(16000, n_fft=768)) == 2


# -------------------------------------------------- the FFT's index algebra --
def _w64(j):
    """w64 of fft_regs.cuh: the float32 quarter-wave table and the quadrant
    of j, as the complex value W_64^j."""
    c = np.cos(2 * np.pi * np.arange(17) / 64).astype(np.float32)
    c[16] = 0.0
    q, h = j & 15, j >> 4
    cs, sn = float(c[q]), float(c[16 - q])
    cs, sn = [(cs, sn), (-sn, cs), (-cs, -sn), (sn, -cs)][h]
    return complex(cs, -sn)


def _dft(v):
    """dft<R> of fft_regs.cuh over the last axis: R <= 8 as K1's tests hold
    it, R = 16 and 32 by even and odd halves and the W_64 table."""
    r = v.shape[-1]
    if r <= 8:
        return np.fft.fft(v, axis=-1)
    e, o = _dft(v[..., 0::2]), _dft(v[..., 1::2])
    t = o * np.array([_w64(k * (64 // r)) for k in range(r // 2)])
    return np.concatenate([e + t, e - t], axis=-1)


def _plan(nc):
    return (32, 32) if nc == 1024 else (8, 8) + ((nc // 64,) if nc > 64 else ())


def _path1_fft(z):
    """fft_regs<NC> over the last axis of z (..., nc): lane lt holds point
    lt + TPF q; each pass but the last at nc = 1024 writes its Stockham
    places into an xpad buffer and the lanes gather back.  Returns Z in
    natural order, and at nc = 1024 also the registers a (..., lane, r)."""
    nc = z.shape[-1]
    n = 2 * nc
    tpf = _lanes(nc)
    p = nc // tpf
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    lt = np.arange(tpf)
    a = z[..., lt[:, None] + tpf * np.arange(p)[None, :]]  # (..., tpf, p)
    ns = 1
    plan = _plan(nc)
    for step_i, r in enumerate(plan):
        if nc == 1024 and step_i == len(plan) - 1:
            # pass_last: W_nc^{lt q} = w8^(q >> 3) w1^(q & 7), the kernel's products
            w1, w8 = tw[2 * lt], tw[16 * lt]
            twq = np.empty((tpf, 32), complex)
            wb = np.ones(tpf, complex)
            for c in range(4):
                w = wb.copy()
                for rr in range(8):
                    twq[:, 8 * c + rr] = w
                    w = w * w1
                wb = wb * w8
            np.testing.assert_allclose(twq, tw[(2 * lt[:, None] * np.arange(32)) % n], atol=1e-12)
            a = _dft(a * twq)  # a[..., lt, r] = Z[lt + 32 r]
            return a.reshape(a.shape[:-2] + (-1,))[..., _natural(tpf)], a
        u_n, step = p // r, 2 * nc // (ns * r)
        buf = np.full(z.shape[:-1] + (_xpad(nc, nc) + 1,), np.nan, complex)
        written = np.zeros(buf.shape[-1], int)
        for u in range(u_n):
            b = lt + tpf * u
            k = b & (ns - 1)
            q = np.arange(r)
            v = a[..., u + q * u_n]  # (..., tpf, r)
            if ns > 1:
                v = v * tw[(k[:, None] * q[None, :] * step)]
            base = (b - k) * r + k
            idx = np.array([[_xpad(nc, int(bb) + rr * ns) for rr in range(r)] for bb in base])
            buf[..., idx] = _dft(v)
            np.add.at(written, idx.ravel(), 1)
        assert written.max() == 1 and written.sum() == nc  # each place once
        ns *= r
        gidx = np.array([[_xpad(nc, int(ll) + tpf * qq) for qq in range(p)] for ll in lt])
        a = buf[..., gidx]
    return buf[..., [_xpad(nc, i) for i in range(nc)]], None


def _natural(tpf):
    """The flat (lane, r) index of Z[i] = a[i % 32, i // 32]."""
    return np.array([(i % tpf) * 32 + i // tpf for i in range(32 * tpf)])


@pytest.mark.parametrize("nc", [64, 128, 256, 512, 1024])
def test_path1_fft_index_algebra_matches_numpy(nc):
    rng = np.random.default_rng(nc)
    z = rng.normal(size=(3, nc)) + 1j * rng.normal(size=(3, nc))
    want = np.fft.fft(z, axis=-1)
    got, _ = _path1_fft(z)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_exchange_padding_is_conflict_free_at_1024():
    """The radix-32 pass writes points 32 lt + r and the gather reads
    lt + 32 q: with one float skipped every 32, each warp-wide access
    touches 32 distinct banks."""
    lanes = np.arange(32)
    for r in range(32):
        assert len({_xpad(1024, 32 * int(l) + r) % 32 for l in lanes}) == 32
        assert len({_xpad(1024, int(l) + 32 * r) % 32 for l in lanes}) == 32


def test_register_split_partner_and_twiddle():
    """After pass_last lane lt holds Z[lt + 32 j] in a[j]; split_partner
    fetches Z[(nc - k) % nc] for k = lt + 32 j from lane (32 - lt) & 31 at
    register 31 - j (lane 0: (32 - j) & 31); W_n^k = W_n^lt W_64^j."""
    nc, n = 1024, 2048
    rng = np.random.default_rng(7)
    z = rng.normal(size=nc) + 1j * rng.normal(size=nc)
    zf, a = _path1_fft(z)
    np.testing.assert_allclose(zf, np.fft.fft(z), atol=1e-6 * np.abs(zf).max())
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    for lt in range(32):
        for j in range(32):
            k = lt + 32 * j
            np.testing.assert_allclose(a[lt, j], zf[k], atol=1e-6 * np.abs(zf).max())
            src = (32 - lt) & 31
            reg = 31 - j if src else (32 - j) & 31  # the sender's register
            np.testing.assert_allclose(a[src, reg], zf[(nc - k) % nc],
                                       atol=1e-6 * np.abs(zf).max())
            assert abs(tw[lt] * _w64(j) - tw[k]) < 1e-6


# ------------------------------------------------------------- tile staging --
def _stage(sig_row_off, x, avail, length, slab_floats):
    """stage_tile of fft_regs.cuh on a flat float32 signal: the slab gets
    sample i at head + i (head = the first sample's misalignment in floats,
    the signal's base 16-byte aligned), zeros past avail."""
    head = sig_row_off & 3
    pre = min((4 - head) & 3, avail)
    n16 = (avail - pre) // 4
    slab = np.full(slab_floats, np.nan, np.float32)
    slab[head:head + pre] = x[:pre]
    for v in range(n16):
        d = head + pre + 4 * v
        assert d % 4 == 0 and (sig_row_off + pre + 4 * v) % 4 == 0  # both 16-byte aligned
        slab[d:d + 4] = x[pre + 4 * v:pre + 4 * v + 4]
    tail = pre + 4 * n16
    slab[head + tail:head + avail] = x[tail:avail]
    slab[head + avail:head + length] = 0.0
    return slab, head


@pytest.mark.parametrize("t_extra", [0, 3], ids=["T multiple of 4", "T not a multiple of 4"])
@pytest.mark.parametrize("hop", [512, 160, 130, 100, 333])
def test_tile_staging_gives_each_frame_its_samples(hop, t_extra):
    """The kernel's tile loop for B = 2 rows: tile t is row t // tiles, frames
    f0 .. f0 + 15; frame s of the tile reads slab[head + s hop + i], as
    float2 pairs when head + s hop is even, as scalars when odd (an odd
    hop gives both); frames past F read the slab's zeros and are not
    written."""
    n = 2048 if hop in (512, 100, 333) else 512
    b_rows = 2
    t_len = 4 * (n + 7 * hop) + t_extra
    f = 1 + (t_len - n) // hop
    sig = np.random.default_rng(hop).normal(size=(b_rows, t_len)).astype(np.float32)
    flat = sig.ravel()
    tiles = -(-f // TILE_F)
    length = (TILE_F - 1) * hop + n
    slab_floats = -(-(length + 3) // 4) * 4
    assert slab_floats * 4 * 2 <= pk.fft_smem_bytes(n, hop, n // 2 + 1, 0, 1, 1)
    parities = set()
    for t in range(b_rows * tiles):
        b, f0 = divmod(t, tiles)
        f0 *= TILE_F
        off = b * t_len + f0 * hop
        avail = min(t_len - f0 * hop, length)
        slab, head = _stage(off, flat[off:], avail, length, slab_floats)
        assert not np.isnan(slab[head:head + length]).any()
        for s in range(TILE_F):
            start = head + s * hop
            parities.add(start % 2)
            frame = slab[start:start + n]
            if f0 + s < f:
                assert np.array_equal(frame, sig[b, (f0 + s) * hop:(f0 + s) * hop + n])
            else:
                beyond = max(t_len - (f0 + s) * hop, 0)
                assert not frame[beyond:].any()
    if hop % 2:
        assert parities == {0, 1}


def _stage_reflect(row_off, row, v0, length, half, slab_floats):
    """stage_reflect of fft_regs.cuh on a row of T samples at float offset
    row_off from a 16-byte boundary: virtual sample p of the reflect-padded
    row (p < 0 reads row[-p], p >= T row[2T - 2 - p], zeros from T + half)
    goes to head + p - v0, head = (row_off + v0) & 3; the row's own samples
    through stage_tile (``_stage``) from a base a multiple of 4 floats into
    the slab."""
    t = row.size
    head = (row_off + v0) & 3
    slab = np.full(slab_floats, np.nan, np.float32)
    end = v0 + length
    lo, hi, rend = max(v0, 0), min(end, t), min(end, t + half)
    assert v0 < t and lo < hi <= rend <= end
    for p in range(v0, 0):
        slab[head + p - v0] = row[-p]
    base = head + (lo - v0) - ((row_off + lo) & 3)
    assert base >= 0 and base % 4 == 0
    sub, sub_head = _stage(row_off + lo, row[lo:], hi - lo, hi - lo, slab_floats - base)
    slab[base + sub_head:base + sub_head + hi - lo] = sub[sub_head:sub_head + hi - lo]
    for p in range(hi, rend):
        slab[head + p - v0] = row[2 * t - 2 - p]
    slab[head + rend - v0:head + end - v0] = 0.0
    return slab, head


# (n_fft, hop, frames a tile): the three cells' K2 paths (1, 1 and 3) and an odd hop
REFLECT_TILES = [(2048, 512, TILE_F), (512, 160, TILE_F), (400, 160, 32), (512, 161, TILE_F)]


@pytest.mark.parametrize("row_off", [0, 1], ids=["aligned", "offset 1"])
@pytest.mark.parametrize("t_kind", ["n/2 + 1", "T%4=0", "T%4=1", "T%4=2", "T%4=3"])
@pytest.mark.parametrize("n,hop,tile_f", REFLECT_TILES,
                         ids=[f"{n}/{h}" for n, h, _ in REFLECT_TILES])
def test_reflect_staging_gives_each_frame_the_padded_rows_samples(n, hop, tile_f, t_kind,
                                                                  row_off):
    """The kernel's reflect tile loop (kReflect) for B = 2 unpadded rows:
    tile t is row t // tiles, frames f0 .. f0 + tile_f - 1 from virtual
    sample f0 hop - n/2; every frame below F = 1 + T // hop reads exactly
    what it reads from ``np.pad(row, n/2, "reflect")``, later frames read
    zeros past T + n/2, the slab holds the tile, and path 2's folded index
    is numpy's reflection."""
    half = n // 2
    t_len = half + 1 if t_kind == "n/2 + 1" else 4 * (n + 7 * hop) + int(t_kind[-1])
    f = 1 + t_len // hop
    sig = np.random.default_rng(n + hop + t_len).normal(size=(2, t_len)).astype(np.float32)
    tiles = -(-f // tile_f)
    length = (tile_f - 1) * hop + n
    slab_floats = -(-(length + 3) // 4) * 4
    p = np.arange(-half, t_len + half)
    fold = np.where(p < 0, -p, np.where(p < t_len, p, 2 * t_len - 2 - p))
    for b in range(2):
        padded = np.pad(sig[b], half, mode="reflect")
        assert np.array_equal(sig[b][fold], padded)  # path 2's index
        for j in range(tiles):
            f0 = j * tile_f
            slab, head = _stage_reflect(row_off + b * t_len, sig[b], f0 * hop - half, length,
                                        half, slab_floats)
            assert not np.isnan(slab[head:head + length]).any()
            for s in range(tile_f):
                frame = slab[head + s * hop:head + s * hop + n]
                if f0 + s < f:
                    assert np.array_equal(frame, padded[(f0 + s) * hop:(f0 + s) * hop + n])
                else:
                    beyond = max(t_len + 2 * half - (f0 + s) * hop, 0)
                    assert not frame[beyond:].any()


# --------------------------------------------------------- the whole function --
def _path1_form(x, cfg):
    """float64 numpy of path 1's function on x (B, T) uncentred: frames of
    n samples every hop, the window, z = xw[2t] + i xw[2t+1], the mirrored
    passes, the split (W_n^k = W_n^lt W_64^j at nc = 1024, tw[k] below),
    |X|^2 of the kmax bins and each filter's packed range."""
    n, hop = cfg.fft_points, cfg.frame_step
    win, tw, wpack, ranges, kmax = pk._kernel_constants(cfg)
    nc = n // 2
    f = max(1 + (x.shape[-1] - n) // hop, 0)
    frames = np.stack([x[:, i * hop:i * hop + n] for i in range(f)], axis=1) * win
    z, _ = _path1_fft(frames[..., 0::2] + 1j * frames[..., 1::2])
    k = np.arange(kmax)
    zk, zm = z[..., k % nc], np.conj(z[..., (nc - k) % nc])
    w = tw[:, 0].astype(np.float64) - 1j * tw[:, 1].astype(np.float64)
    if nc == 1024:
        wk = w[k % 32] * np.array([_w64(int(j) & 63) for j in k // 32])
    else:
        wk = w[k]
    spec = 0.5 * (zk + zm) - 0.5j * (zk - zm) * wk
    pw = np.abs(spec) ** 2
    if kmax > nc:  # the Nyquist bin: Re Z[0] - Im Z[0]
        pw[..., nc] = (z[..., 0].real - z[..., 0].imag) ** 2
    return np.stack([pw[..., lo:hi] @ wpack[off:off + hi - lo].astype(np.float64)
                     for lo, hi, off in ranges], axis=-1)


# (name, librosa_config kwargs, shape, held to the JAX kernel too): the
# reference's Pallas kernel raises ZeroDivisionError in interpret mode at
# n_fft 256, so that config is held to the plain version only
FORMS = [
    ("2048/512", dict(sample_rate=22050), (2, 9000), True),
    ("2048/333 odd hop", dict(sample_rate=22050, hop_length=333), (1, 7001), True),
    ("1024/256", dict(sample_rate=16000, n_fft=1024, hop_length=256), (1, 6001), True),
    ("512/160/80", dict(sample_rate=16000, n_fft=512, hop_length=160, n_mels=80), (2, 4003), True),
    ("256/64", dict(sample_rate=8000, n_fft=256, n_mels=40), (1, 3000), False),
]


@pytest.mark.parametrize("name,kw,shape,with_jax", FORMS, ids=[c[0] for c in FORMS])
def test_path1_form_matches_plain_and_jax_kernel(name, kw, shape, with_jax):
    jcfg = m.librosa_config(**kw).replace(center=False)
    cfg = P.from_reference(dataclasses.asdict(jcfg))
    assert pk.path_for(cfg) == 1, name
    x = np.random.default_rng(41).normal(0, 0.1, shape).astype(np.float32)
    plain = pk.ct_mel_plain(torch.from_numpy(x), cfg).numpy()
    form = _path1_form(x.astype(np.float64), cfg)
    assert rel(form, plain) <= 1e-5, name
    if with_jax:
        assert jk.pallas_ct_supported(jcfg), name
        ref = np.asarray(jk.ct_mel_pallas(jnp.asarray(x), jcfg, interpret=True))
        assert rel(form, ref) <= 1e-5, name


# ------------------------------------------------- path 3: nc = 200 = 8 x 25 --
_F32 = lambda v: float(np.float32(v))


def _w25(j):
    """w25 of fft_regs.cuh as the complex value W_25^j (float32 constants)."""
    return complex(_F32(np.cos(2 * np.pi * j / 25)), -_F32(np.sin(2 * np.pi * j / 25)))


def _dft5(x):
    """dft5 of fft_regs.cuh over the last axis (t1 = x1 + x4, t2 = x2 + x3,
    t3 = x1 - x4, t4 = x2 - x3 and its float32 c1, c2, s1, s2)."""
    c1, c2 = _F32(np.cos(2 * np.pi / 5)), _F32(np.cos(4 * np.pi / 5))
    s1, s2 = _F32(np.sin(2 * np.pi / 5)), _F32(np.sin(4 * np.pi / 5))
    x0, x1, x2, x3, x4 = (x[..., i] for i in range(5))
    t1, t2, t3, t4 = x1 + x4, x2 + x3, x1 - x4, x2 - x3
    m1, m2 = x0 + c1 * t1 + c2 * t2, x0 + c2 * t1 + c1 * t2
    u1, u2 = s1 * t3 + s2 * t4, s2 * t3 - s1 * t4
    return np.stack([x0 + t1 + t2, m1 - 1j * u1, m2 - 1j * u2, m2 + 1j * u2, m1 + 1j * u1],
                    axis=-1)


def _dft25(a):
    """dft25: q = q2 + 5 q1, the DFTs over q1, W_25^{q2 k1}, the DFTs over
    q2; out in natural order k = k1 + 5 k2."""
    b = _dft5(a.reshape(a.shape[:-1] + (5, 5)).swapaxes(-1, -2))  # [..., q2, k1]
    b = b * np.array([[_w25(q2 * k1) for k1 in range(5)] for q2 in range(5)])
    y = _dft5(b.swapaxes(-1, -2))  # [..., k1, k2]
    return y.swapaxes(-1, -2).reshape(a.shape)  # index k1 + 5 k2


def _rev3(x):
    return ((x & 1) << 2) | (x & 2) | (x >> 2)


def _lane_twiddles():
    """w8 and w4 of tile_path3 for lanes 0..7: W_8^{lt & 3} on lanes with
    bit 2, W_4^{lt & 1} on lanes with bit 1, else 1."""
    lt = np.arange(8)
    w8 = np.where(lt & 4, np.exp(-2j * np.pi * (lt & 3) / 8), 1)
    w4 = np.where(lt & 2, np.exp(-2j * np.pi * (lt & 1) / 4), 1)
    return w8, w4


def _fft200(z):
    """fft200 of fft_regs.cuh on z (..., 200): lane lt holds z[lt + 8 q] in
    a[q]; dft25, the twiddles tw1[8 k2 + lt] = tw[2 lt k2], then dft8_lanes:
    at masks 4, 2, 1 each lane takes its partner's register (lane ^ mask),
    the lower lane keeps a + p, the upper p - a, times its stage twiddle.
    Returns a (..., lane, k2)."""
    n = 400
    tw = np.exp(-2j * np.pi * np.arange(n) / n)
    lt = np.arange(8)
    a = _dft25(z[..., lt[:, None] + 8 * np.arange(25)[None, :]])
    idx = 2 * lt[:, None] * np.arange(25)[None, :]
    assert idx.max() < n  # no modulo
    a = a * tw[idx]
    w8, w4 = _lane_twiddles()
    for mask, w in ((4, w8), (2, w4), (1, np.ones(8))):
        p = a[..., lt ^ mask, :]
        upper = (lt & mask)[:, None] != 0
        a = np.where(upper, p - a, a + p) * w[:, None]
    return a


def test_path3_fft_index_algebra_matches_numpy():
    """Lane lt holds the points lt + 8 q, each lane's 5 x 5 DFT is its
    25-point DFT, and after the W_200 twiddles and the lane stages lane lt
    holds Z[k2 + 25 rev3(lt)] in a[k2]: every bin once."""
    rng = np.random.default_rng(200)
    z = rng.normal(size=(3, 200)) + 1j * rng.normal(size=(3, 200))
    want = np.fft.fft(z, axis=-1)
    v = z[..., :25]
    np.testing.assert_allclose(_dft25(v), np.fft.fft(v, axis=-1), atol=1e-6 * np.abs(v).sum())
    a = _fft200(z)
    k = np.arange(25)[None, :] + 25 * np.array([_rev3(i) for i in range(8)])[:, None]
    assert sorted(k.ravel()) == list(range(200))
    np.testing.assert_allclose(a, want[..., k], rtol=0, atol=1e-6 * np.abs(want).max())


def test_path3_split_partner_tables_and_banks():
    """For k = k2 + 25 rev3(lt), Z[(200 - k) % 200] sits in lane lt ^ 7 at
    register 25 - k2 (k2 > 0) or in lane rev3(-rev3(lt) & 7) at register 0;
    tw2[8 k2 + lt] = W_400^k with k < 200; and the power writes of a warp
    (bin k of frame g at 4 k + g, lanes at k = k2 + 25 rev3(lt)) hit 32
    distinct banks for every k2, the 4 x 201 bins of n = 400 fitting kPw3."""
    rng = np.random.default_rng(201)
    z = rng.normal(size=200) + 1j * rng.normal(size=200)
    zf = np.fft.fft(z)
    a = _fft200(z)
    tol = 1e-6 * np.abs(zf).max()
    tw = np.exp(-2j * np.pi * np.arange(400) / 400)
    for lt in range(8):
        k1 = _rev3(lt)
        for k2 in range(25):
            kk = k2 + 25 * k1
            src, reg = (lt ^ 7, 25 - k2) if k2 else (_rev3(-k1 & 7), 0)
            np.testing.assert_allclose(a[src, reg], zf[(200 - kk) % 200], atol=tol)
            assert kk < 200 and abs(tw[kk] - np.exp(-2j * np.pi * kk / 400)) < 1e-12
    assert pk._PW3 >= 4 * 201 and pk._PW3 % 4 == 0
    for k2 in range(25):
        banks = {(4 * (k2 + 25 * _rev3(lt)) + g) % 32 for g in range(4) for lt in range(8)}
        assert len(banks) == 32, k2


def test_path3_plan_at_whisper_hop():
    """n = 400 at hop 160 takes path 3 with 8 warps in at most 232,448
    bytes (two blocks an SM), Layout3's sum; a 32-frame tile gives each warp
    of 8, 4, 2 or 1 whole rounds of 4 frames, every frame to one lane
    group."""
    for m in (80, 128):
        cfg = P.librosa_config(16000, n_fft=400, hop_length=160, n_mels=m)
        _, _, wpack, _, kmax = pk._kernel_constants(cfg)
        args = (400, 160, kmax, wpack.size, m)
        assert (kmax, pk.path_for(cfg), pk.fft_path(*args), pk.fft_warps(*args)) == (200, 3, 3, 8)
        slab = -(-(31 * 160 + 400 + 3) // 4) * 4
        want = 4 * (2 * slab + 400 + 800 + -(-wpack.size // 4) * 4 + -(-3 * m // 4) * 4
                    + 8 * 816)
        assert pk.fft_smem_bytes(*args, 8) == want and 2 * want <= 232448, m
    for nw in (8, 4, 2, 1):
        seen = [s for w in range(nw) for g in range(4) for s in range(w * 4 + g, 32, nw * 4)]
        assert sorted(seen) == list(range(32))
        rounds = {len(range(w * 4 + g, 32, nw * 4)) for w in range(nw) for g in range(4)}
        assert rounds == {32 // (4 * nw)}


def _path3_form(x, cfg):
    """float64 numpy of path 3's function on x (B, T) uncentred: frames,
    the window, z = xw[2t] + i xw[2t+1], the mirrored fft200, the split from
    the lanes' registers with W_400^k, |X|^2 of the kmax bins and each
    filter's packed range."""
    n, hop = cfg.fft_points, cfg.frame_step
    win, tw, wpack, ranges, kmax = pk._kernel_constants(cfg)
    f = max(1 + (x.shape[-1] - n) // hop, 0)
    frames = np.stack([x[:, i * hop:i * hop + n] for i in range(f)], axis=1) * win
    a = _fft200(frames[..., 0::2] + 1j * frames[..., 1::2])
    z = np.empty(a.shape[:-2] + (200,), complex)
    for lt in range(8):
        z[..., np.arange(25) + 25 * _rev3(lt)] = a[..., lt, :]
    k = np.arange(kmax)
    zk, zm = z[..., k % 200], np.conj(z[..., (200 - k) % 200])
    w = tw[:, 0].astype(np.float64) - 1j * tw[:, 1].astype(np.float64)
    pw = np.abs(0.5 * (zk + zm) - 0.5j * (zk - zm) * w[k]) ** 2
    if kmax > 200:
        pw[..., 200] = (z[..., 0].real - z[..., 0].imag) ** 2
    return np.stack([pw[..., lo:hi] @ wpack[off:off + hi - lo].astype(np.float64)
                     for lo, hi, off in ranges], axis=-1)


@pytest.mark.parametrize("m,shape,hop", [(128, (2, 9000), 160), (80, (1, 7001), 160),
                                         (128, (1, 5003), 161)],
                         ids=["400/160/128", "400/160/80", "400/161 odd hop"])
def test_path3_form_matches_plain(m, shape, hop):
    cfg = P.librosa_config(16000, n_fft=400, hop_length=hop, n_mels=m).replace(center=False)
    assert pk.path_for(cfg) == 3
    x = np.random.default_rng(42).normal(0, 0.1, shape).astype(np.float32)
    plain = pk.ct_mel_plain(torch.from_numpy(x), cfg).numpy()
    assert rel(_path3_form(x.astype(np.float64), cfg), plain) <= 1e-5
