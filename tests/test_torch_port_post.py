"""The PyTorch port's post-processing (deltas, CMVN, corpus moments) on the
CPU against the JAX reference on the same seeded inputs, and against the
float64 speechpy oracle and its frozen fixtures.

Tolerances (max|Δ|/max|ref|): <= 1e-5 in float32, <= 1e-9 in float64, and
the reference's 5e-3 float32 gate against the oracle."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_rust_tpu.ops import delta as jdelta
from mfcc_rust_tpu.ops import normalize as jnorm
from tests.golden import speechpy_ref as sp
from tests.golden.gen_fixtures import FIXTURE_DIR, fixture_inputs

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.ops import delta as pdelta
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.ops import normalize as pnorm

TOL = {"float32": 1e-5, "float64": 1e-9}
DTYPES = ["float32", "float64"]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _feats(shape, dtype, seed, loc=1.0, scale=2.0):
    x = np.random.default_rng(seed).normal(loc, scale, shape).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


# ------------------------------------------------------------------ deltas --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,windows", [((40, 13), 2), ((3, 25, 20), 1), ((2, 30, 5), 4)],
                         ids=["2-D w2", "3-D w1", "w > half the features"])
def test_derivative_extraction_matches_jax(shape, windows, dtype):
    jx, px = _feats(shape, dtype, 0)
    got = pdelta.derivative_extraction(px, windows)
    assert got.dtype == px.dtype
    assert rel(got, jdelta.derivative_extraction(jx, windows)) <= TOL[dtype]
    cube = pdelta.extract_derivative_feature(px)
    assert cube.shape == shape + (3,)
    assert rel(cube, jdelta.extract_derivative_feature(jx)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_derivative_extraction_matches_oracle_and_fixture(dtype):
    _, _, feat = fixture_inputs()
    got = pdelta.derivative_extraction(torch.from_numpy(feat.astype(dtype)), 2)
    frozen = np.load(FIXTURE_DIR / "speechpy_delta.npy")
    assert rel(got, frozen) <= (5e-3 if dtype == "float32" else 1e-9)
    cube = pdelta.extract_derivative_feature(torch.from_numpy(feat.astype(dtype)))
    assert rel(cube, sp.extract_derivative_feature(feat)) <= (5e-3 if dtype == "float32" else 1e-9)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,width", [((50, 13), 2), ((2, 30, 13), 3), ((3, 40), 1),
                                         ((4, 13), 5)],
                         ids=["2-D", "3-D", "1 feature axis of 40", "T < width (edge pad)"])
def test_delta_matches_jax(shape, width, dtype):
    jx, px = _feats(shape, dtype, 1)
    got = pdelta.delta(px, width)
    assert got.dtype == px.dtype
    assert rel(got, jdelta.delta(jx, width)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,width,order,axis", [
    ((13, 50), 9, 1, -1), ((13, 50), 5, 2, -1), ((2, 20, 13), 9, 1, 1), ((2, 13, 9), 9, 3, -1),
], ids=["9/1", "5/2", "axis 1 of 3-D", "T = width, order 3"])
def test_delta_librosa_matches_jax(shape, width, order, axis, dtype):
    jx, px = _feats(shape, dtype, 2)
    got = pdelta.delta_librosa(px, width, order, axis)
    assert got.dtype == px.dtype
    assert rel(got, jdelta.delta_librosa(jx, width, order, axis)) <= TOL[dtype]


def test_delta_librosa_raises_as_reference():
    x = torch.zeros((13, 20))
    for kw in ({"width": 4}, {"width": 1}, {"order": 0}, {"width": 3, "order": 3}):
        with pytest.raises(ValueError):
            pdelta.delta_librosa(x, **kw)
        with pytest.raises(ValueError):
            jdelta.delta_librosa(jnp.zeros((13, 20)), **kw)
    with pytest.raises(ValueError, match="at least width"):
        pdelta.delta_librosa(torch.zeros((13, 8)), 9)
    assert pdelta._savgol_operator(9, 1, 1) is pdelta._savgol_operator(9, 1, 1)


def test_pad_signal_along_a_dim_matches_numpy():
    x = np.random.default_rng(3).normal(size=(2, 5, 3))
    for mode in ("edge", "symmetric", "reflect", "constant"):
        for left, right in ((2, 3), (12, 7)):
            if mode == "reflect" and left >= 5:
                left = right = 9  # reflect again and again
            got = pframing.pad_signal(torch.from_numpy(x), left, right, mode, dim=-2)
            ref = np.pad(x, [(0, 0), (left, right), (0, 0)], mode=mode)
            np.testing.assert_array_equal(got.numpy(), ref)


# -------------------------------------------------------------------- CMVN --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variance", [False, True])
def test_cmvn_matches_jax_and_oracle(variance, dtype):
    jx, px = _feats((2, 200, 13), dtype, 4)
    got = pnorm.cmvn(px, variance)
    assert got.dtype == px.dtype
    assert rel(got, jnorm.cmvn(jx, variance)) <= TOL[dtype]
    one = np.asarray(jx[0], np.float64)
    assert rel(got[0], sp.cmvn(one, variance)) <= (5e-3 if dtype == "float32" else 1e-9)


def test_cmvn_large_mean_float32():
    """The two-pass mean keeps a +1e4 offset from leaving its rounding in
    the centred features."""
    jx, px = _feats((500, 13), "float32", 5, loc=1e4, scale=1.0)
    got = pnorm.cmvn(px, True)
    assert rel(got, jnorm.cmvn(jx, True)) <= 1e-5
    assert rel(got, sp.cmvn(np.asarray(jx, np.float64), True)) <= 5e-3


# (name, shape, window): T < pad is the default 301 window on 40 frames
CMVNW = [("T=200, win 31", (200, 13), 31), ("T=40 < pad, win 301", (40, 13), 301),
         ("3-D, win 5", (2, 30, 13), 5), ("T=1", (1, 13), 301)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variance", [False, True])
@pytest.mark.parametrize("name,shape,win", CMVNW, ids=[c[0] for c in CMVNW])
def test_cmvnw_matches_jax_and_oracle(name, shape, win, variance, dtype):
    jx, px = _feats(shape, dtype, 6)
    got = pnorm.cmvnw(px, win, variance)
    assert got.dtype == px.dtype
    ref = jnorm.cmvnw(jx, win, variance)
    if name == "T=1":  # the one row is its own window mean
        assert float(torch.abs(got).max()) == 0.0 and float(jnp.abs(ref).max()) == 0.0
        return
    assert rel(got, ref) <= TOL[dtype], name
    one = np.asarray(jx, np.float64).reshape((-1,) + shape[-2:])[0]
    assert rel(got.reshape((-1,) + shape[-2:])[0], sp.cmvnw(one, win, variance)) <= (
        5e-3 if dtype == "float32" else 1e-9), name


def test_cmvnw_fixture_and_large_mean():
    _, _, feat = fixture_inputs()
    frozen = np.load(FIXTURE_DIR / "speechpy_cmvnw.npy")
    assert rel(pnorm.cmvnw(torch.from_numpy(feat), 31, True), frozen) <= 1e-9
    assert rel(pnorm.cmvnw(torch.from_numpy(feat.astype(np.float32)), 31, True), frozen) <= 5e-3
    jx, px = _feats((300, 13), "float32", 7, loc=1e4, scale=1.0)
    assert rel(pnorm.cmvnw(px, 101, True), jnorm.cmvnw(jx, 101, True)) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variance", [False, True])
@pytest.mark.parametrize("shape", [(98, 13), (2, 30, 13), (1, 13)], ids=["2-D", "3-D", "T=1"])
def test_cmvnw_win1_is_exact_zeros_like_the_oracle(shape, variance, dtype):
    """A one-row window is its own mean: exact zeros, as the float64 oracle
    gives (JAX's float32 cumulative-sum residue over a std near EPS reaches
    ~1e3 here; the port does not copy it)."""
    _, px = _feats(shape, dtype, 10)
    got = pnorm.cmvnw(px, 1, variance)
    assert got.dtype == px.dtype and got.shape == px.shape
    assert not got.any()
    one = px.double().numpy().reshape((-1,) + shape[-2:])[0]
    np.testing.assert_array_equal(got.numpy().reshape((-1,) + shape[-2:])[0],
                                  sp.cmvnw(one, 1, variance))
    assert not P.cmvnw(px.numpy(), 1, variance, device="cpu").any()


@pytest.mark.parametrize("seed", range(4))
def test_cmvnw_win3_float32_error(seed):
    """The float32 error of the smallest computed window, on the MFCCs of a
    1 s random clip (seed 0: max|Δ| 0.0269 for the port and for JAX, on
    outputs up to 15.58; ROADMAP "Settled"): inside the 5e-3 gate."""
    x = np.random.default_rng(seed).normal(0, 0.1, 16000).astype(np.float32)
    f = P.mfcc(x, 16000, device="cpu")
    ref = sp.cmvnw(f.double().numpy(), 3, True)
    assert rel(pnorm.cmvnw(f, 3, True), ref) <= 5e-3
    assert rel(jnorm.cmvnw(jnp.asarray(f.numpy()), 3, True), ref) <= 5e-3
    # at win_size 1 the port gives the oracle's zeros where the reference
    # leaves its float32 residue over a std near EPS (1,056-1,376 on seeds 0-3)
    assert not pnorm.cmvnw(f, 1, True).any() and not sp.cmvnw(f.double().numpy(), 1, True).any()
    assert float(np.abs(jnorm.cmvnw(jnp.asarray(f.numpy()), 1, True)).max()) > 100.0


def test_cmvnw_even_window_raises():
    with pytest.raises(ValueError, match="odd"):
        pnorm.cmvnw(torch.zeros((20, 13)), 300)


# ------------------------------------------------------------ corpus CMVN --
@pytest.mark.parametrize("masked", [False, True])
def test_masked_moments_matches_jax(masked):
    jx, px = _feats((3, 20, 13), "float64", 8)
    mask = np.random.default_rng(9).random((3, 20)) > 0.3 if masked else None
    pm = pnorm.masked_moments(px, None if mask is None else torch.from_numpy(mask))
    jm = jnorm.masked_moments(jx, None if mask is None else jnp.asarray(mask))
    for a, b in zip(pm, jm):
        assert a.dtype == torch.float64
        assert rel(a, b) <= 1e-12
    assert float(pm[2]) == (mask.sum() if masked else 60)


@pytest.mark.parametrize("variance", [False, True])
@pytest.mark.parametrize("form", ["triple", "welford"])
def test_apply_corpus_cmvn_matches_jax(form, variance):
    jx, px = _feats((2, 30, 13), "float32", 10)
    if form == "triple":
        pm = pnorm.masked_moments(px)
        jm = jnorm.masked_moments(jx)
    else:
        data = np.asarray(jx, np.float64).reshape(-1, 13)
        stats = {"m2": ((data - data.mean(0)) ** 2).sum(0), "mean": data.mean(0),
                 "std": data.std(0)}
        pm = types.SimpleNamespace(**{k: torch.from_numpy(v.astype(np.float32))
                                      for k, v in stats.items()})
        jm = types.SimpleNamespace(**{k: jnp.asarray(v, jnp.float32) for k, v in stats.items()})
    got = pnorm.apply_corpus_cmvn(px, pm, variance)
    assert rel(got, jnorm.apply_corpus_cmvn(jx, jm, variance)) <= 1e-5
    ref = sp.cmvn(np.asarray(jx, np.float64).reshape(-1, 13), variance).reshape(2, 30, 13)
    assert rel(got, ref) <= 5e-3
