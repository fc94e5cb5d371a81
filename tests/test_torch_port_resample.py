"""The PyTorch port's polyphase resampler on the CPU against the JAX
reference on the same seeded inputs and against the literal zero-stuff /
convolve float64 oracle ``tests/golden/resample_ref.py``.

Tolerances: float64 at rtol 1e-9, atol 1e-12 (the reference's own oracle
gate); float32 at the reference's rtol 2e-4, atol 2e-5 against the oracle
(``tests/test_resample.py``) and max|Δ|/max|ref| <= 1e-5 against JAX."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu.ops import resample as jres
from tests.golden.resample_ref import resample_poly_ref

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.ops import resample as pres

PAIRS = [(2, 1), (1, 2), (3, 2), (2, 3), (160, 147), (147, 160), (441, 160), (80, 441)]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("up,down", PAIRS, ids=[f"{u}/{d}" for u, d in PAIRS])
def test_matches_oracle_and_jax_f64(up, down):
    x = np.random.default_rng(0).normal(size=1999)
    ours = pres.resample_poly(torch.from_numpy(x), up, down).numpy()
    ref = resample_poly_ref(x, up, down)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-12)
    assert rel(ours, jres.resample_poly(jnp.asarray(x), up, down)) <= 1e-9


def test_common_rate_pairs():
    x = np.random.default_rng(1).normal(size=4800)
    for orig, tgt in [(48000, 44100), (44100, 16000), (8000, 16000)]:
        y = pres.resample(torch.from_numpy(x), orig, tgt).numpy()
        g = math.gcd(tgt, orig)
        ref = resample_poly_ref(x, tgt // g, orig // g)
        assert y.shape == ref.shape == (-(-len(x) * (tgt // g) // (orig // g)),)
        np.testing.assert_allclose(y, ref, rtol=1e-9, atol=1e-12)


def test_identity_and_gcd_reduction():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=500))
    assert pres.resample_poly(x, 7, 7) is x
    assert torch.equal(pres.resample_poly(x, 4, 6), pres.resample_poly(x, 2, 3))
    assert pres._polyphase_wall(2, 3, 5.0, 10) is pres._polyphase_wall(2, 3, 5.0, 10)


def test_wall_equals_reference():
    for up, down in ((160, 441), (147, 160), (3, 2)):
        pw, pimin, pr = pres._polyphase_wall(up, down, 5.0, 10)
        jw, jimin, jr = jres._polyphase_wall(up, down, 5.0, 10)
        assert (pimin, pr) == (jimin, jr) and np.array_equal(pw, jw)


def test_batch_float32_and_jax():
    x = np.random.default_rng(3).normal(size=(3, 4, 1000)).astype(np.float32)
    y = pres.resample_poly(torch.from_numpy(x), 3, 2)
    assert y.shape == (3, 4, 1500) and y.dtype == torch.float32
    assert rel(y, jres.resample_poly(jnp.asarray(x), 3, 2)) <= 1e-5
    one = pres.resample_poly(torch.from_numpy(x[1, 2]), 3, 2)
    np.testing.assert_allclose(y[1, 2].numpy(), one.numpy(), rtol=1e-6, atol=1e-7)


def test_float32_accuracy():
    x = np.random.default_rng(4).normal(size=2000).astype(np.float32)
    for up, down in ((160, 147), (160, 441)):
        ours = pres.resample_poly(torch.from_numpy(x), up, down).numpy()
        ref = resample_poly_ref(x.astype(np.float64), up, down)
        np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)


def test_api_entry_points():
    x = np.random.default_rng(5).normal(0, 0.1, (2, 4410)).astype(np.float32)
    y = P.resample(x, 44100, 16000, device="cpu")
    assert isinstance(y, torch.Tensor) and y.shape == (2, 1600) and y.dtype == torch.float32
    ref = resample_poly_ref(x[1].astype(np.float64), 160, 441)
    np.testing.assert_allclose(y[1].numpy(), ref, rtol=2e-4, atol=2e-5)
    assert torch.equal(P.resample_poly(x, 160, 441, device="cpu"), y)
    assert P.resample(x, 16000, 16000, device="cpu").shape == x.shape


def test_errors():
    with pytest.raises(ValueError):
        pres.resample_poly(torch.zeros(10), 0, 2)
    with pytest.raises(ValueError):
        pres.resample(torch.zeros(10), 16000, -1)


EMPTY = [("44100 -> 16000", "resample", (44100, 16000)),
         ("16000 -> 22050", "resample", (16000, 22050)),
         ("3/2", "resample_poly", (3, 2))]


@pytest.mark.parametrize("shape", [(0,), (2, 0)], ids=["(0,)", "(2, 0)"])
@pytest.mark.parametrize("name,fn,args", EMPTY, ids=[e[0] for e in EMPTY])
def test_empty_signal_gives_empty_result_like_jax(name, fn, args, shape):
    for dtype in (np.float32, np.float64):
        x = np.zeros(shape, dtype)
        ref = np.asarray(getattr(m, fn)(jnp.asarray(x), *args))
        for got in (getattr(P, fn)(x, *args, device="cpu"),
                    getattr(pres, fn)(torch.from_numpy(x), *args)):
            assert tuple(got.shape) == ref.shape == shape, name
            assert got.dtype == torch.from_numpy(x).dtype


def test_reference_call_with_precision_fourth():
    """The reference's own calls: ``precision`` in fourth place, ``beta``
    by keyword; the port ignores the precision (IEEE FP32 always)."""
    x = np.random.default_rng(6).normal(0, 0.1, (2, 3000)).astype(np.float32)
    jx = jnp.asarray(x)
    got = P.resample_poly(x, 160, 441, "highest", beta=6.0, device="cpu")
    assert rel(got, jres.resample_poly(jx, 160, 441, "highest", beta=6.0)) <= 1e-5
    assert not torch.equal(got, P.resample_poly(x, 160, 441, device="cpu"))  # beta took
    assert torch.equal(P.resample_poly(x, 160, 441, "high", 6.0, 10, device="cpu"), got)
    got = P.resample(x, 44100, 16000, "highest", device="cpu")
    assert rel(got, m.resample(jx, 44100, 16000, "highest")) <= 1e-5
    assert torch.equal(pres.resample(torch.from_numpy(x), 44100, 16000, "default"), got)


def test_signatures_are_the_reference_plus_keyword_only_device():
    for name in ("resample", "resample_poly"):
        ours = inspect.signature(getattr(P, name)).parameters
        ref = inspect.signature(getattr(m, name)).parameters
        assert list(ours)[:-1] == list(ref), name
        assert all(ours[k].default == ref[k].default for k in ref), name
        assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY, name
        assert list(inspect.signature(getattr(pres, name)).parameters) == list(ref), name
    with pytest.raises(TypeError):
        P.resample(np.zeros(10), 16000, 8000, "highest", "cpu")
