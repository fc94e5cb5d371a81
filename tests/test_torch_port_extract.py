"""The PyTorch port's spectral subband centroids and single-pass ``extract``
(plain paths, on the CPU) against the JAX reference on the same seeded
inputs, and against the float64 speechpy oracle and its frozen fixture.

Tolerances (max|Δ|/max|ref|): <= 1e-5 in float32 (two float32 programs
that sum in different orders), <= 3e-5 for log quantities in float32 (the
log turns a small band energy's rounding into its relative error, see
tests/test_torch_port_features.py), <= 1e-9 in float64, the reference's
5e-3 float32 gate against the oracle, and autograd gradients at 1e-5."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import features as JF
from mfcc_rust_tpu.ops import ssc as jssc
from tests.golden import speechpy_ref as sp
from tests.golden.gen_fixtures import FIXTURE_DIR, fixture_inputs

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import ssc as pssc

TOL = {"float32": 1e-5, "float64": 1e-9}
LOG_TOL = {"float32": 3e-5, "float64": 1e-9}
HEADS = ("mfcc", "lmfe", "mfe", "ssc", "energy")


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pair(cfg_kw, shape, dtype, seed=0):
    jcfg = m.speechpy_config(16000, dtype=dtype, **cfg_kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    x = np.random.default_rng(seed).normal(0, 0.1, shape).astype(dtype)
    return jcfg, pcfg, jnp.asarray(x), torch.from_numpy(x)


def _check_heads(pout, jout, dtype, name=""):
    assert pout.keys() == jout.keys(), name
    for k in pout:
        if k == "mfe":
            assert rel(pout[k][0], jout[k][0]) <= TOL[dtype], (name, k)
            assert rel(pout[k][1], jout[k][1]) <= TOL[dtype], (name, k)
        else:
            tol = LOG_TOL[dtype] if k == "lmfe" else TOL[dtype]
            assert rel(pout[k], jout[k]) <= tol, (name, k)


# (name, config kwargs, the path ssc and extract take)
SSC_CONFIGS = [
    ("default 20/10", {}, "chunk-GEMM"),
    ("25/10 r=3", {"frame_length": 0.025}, "chunk-GEMM"),
    ("hann, Parseval product", {"window": "hann"}, "chunk-GEMM"),
    ("preemph, 26 mels", {"preemphasis_cof": 0.97, "num_filters": 26}, "chunk-GEMM"),
    ("fft impl", {"fft_impl": "fft"}, "gather"),
    ("frame > fft", {"frame_length": 0.04}, "gather"),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,kw,path", SSC_CONFIGS, ids=[c[0] for c in SSC_CONFIGS])
def test_ssc_matches_jax_on_both_paths(name, kw, path, dtype):
    jcfg, pcfg, jx, px = _pair(kw, (2, 6000), dtype, seed=1)
    assert PF._fast_path_ok(pcfg) == (path == "chunk-GEMM")
    out = PF.ssc(px, pcfg)
    assert out.dtype == getattr(torch, dtype)
    assert rel(out, JF.ssc(jx, jcfg)) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ssc_matches_oracle_and_fixture(dtype):
    sig16, _, _ = fixture_inputs()
    cfg = P.speechpy_config(16000, dtype=dtype)
    out = PF.ssc(torch.from_numpy(sig16.astype(dtype)), cfg)
    frozen = np.load(FIXTURE_DIR / "speechpy_ssc.npy")
    assert rel(out, frozen) <= (5e-3 if dtype == "float32" else 1e-9)
    x = np.random.default_rng(2).normal(0, 0.1, 9000)
    got = PF.ssc(torch.from_numpy(x.astype(dtype)), cfg.replace(fft_impl="fft"))
    assert rel(got, sp.ssc(x, 16000)) <= (5e-3 if dtype == "float32" else 1e-9)


def test_ssc_from_power_matches_jax():
    """The gather path's SSC op, a zero bin replaced by the float64 epsilon
    in float32 too."""
    jcfg = m.speechpy_config(16000)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    power = np.random.default_rng(3).random((2, 5, jcfg.freq_size)).astype(np.float32)
    power[0, 0, :] = 0.0
    got = pssc.ssc_from_power(torch.from_numpy(power), pcfg)
    ref = jssc.ssc_from_power(jnp.asarray(power), jcfg)
    assert rel(got, ref) <= 1e-5
    assert bool(torch.isfinite(got).all())


SUBSETS = [s for k in range(1, 6) for s in itertools.combinations(HEADS, k)]


@pytest.mark.parametrize("which", SUBSETS, ids=["+".join(s) for s in SUBSETS])
def test_extract_every_subset_matches_jax(which):
    jcfg, pcfg, jx, px = _pair({}, (2, 4000), "float64", seed=4)
    _check_heads(PF.extract(px, pcfg, which), JF.extract(jx, jcfg, which), "float64")


EXTRACT_CONFIGS = [
    ("default", {}, (2, 6000)),
    ("25/10, no dc_elim", {"frame_length": 0.025, "dc_elimination": False}, (2, 6000)),
    ("preemph 0.97", {"preemphasis_cof": 0.97}, (6000,)),
    ("batched 3-D", {}, (2, 2, 4000)),
    ("hann", {"window": "hann"}, (2, 6000)),
    ("non-fast: fft impl", {"fft_impl": "fft"}, (2, 6000)),
    ("non-fast: frame < hop", {"frame_length": 0.005}, (2, 6000)),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,kw,shape", EXTRACT_CONFIGS, ids=[c[0] for c in EXTRACT_CONFIGS])
def test_extract_all_heads_matches_jax(name, kw, shape, dtype):
    jcfg, pcfg, jx, px = _pair(kw, shape, dtype, seed=5)
    pout = PF.extract(px, pcfg, HEADS)
    _check_heads(pout, JF.extract(jx, jcfg, HEADS), dtype, name)
    # the shared pass computes what the separate functions compute
    assert rel(pout["ssc"], PF.ssc(px, pcfg)) <= TOL[dtype], name
    assert rel(pout["lmfe"], PF.lmfe(px, pcfg)) <= TOL[dtype], name


@pytest.mark.parametrize("kw", [{}, {"fft_impl": "fft"}], ids=["chunk-GEMM", "gather"])
def test_extract_empty_clip(kw):
    jcfg, pcfg, jx, px = _pair(kw, (2, 300), "float32", seed=6)
    pout = PF.extract(px, pcfg, HEADS)
    _check_heads(pout, JF.extract(jx, jcfg, HEADS), "float32")
    assert pout["mfcc"].shape == (2, 0, 13) and pout["energy"].shape == (2, 0)
    assert pout["mfe"][0].shape == pout["ssc"].shape == (2, 0, 40)


def test_extract_rejects_unknown_head():
    with pytest.raises(ValueError, match="unknown features"):
        PF.extract(torch.zeros(4000), P.speechpy_config(16000), ("mfcc", "pitch"))


def test_extract_reuses_cached_constants():
    cfg = P.speechpy_config(16000)
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 0.1, 4000).astype(np.float32))
    PF._speechpy_tensors.cache_clear()
    PF.extract(x, cfg, HEADS)
    PF.ssc(x, cfg)
    PF.mfcc(x, cfg)
    info = PF._speechpy_tensors.cache_info()
    assert info.misses == 1 and info.hits == 2


def test_api_ssc_and_extract_match_jax_api():
    x = np.random.default_rng(8).normal(0, 0.1, 12345).astype(np.float32)
    assert rel(P.ssc(x, 16000, device="cpu"), japi.ssc(x, 16000)) <= 1e-5
    pout = P.extract(x, 16000, which=HEADS, device="cpu")
    jout = japi.extract(x, 16000, which=HEADS)
    _check_heads(pout, jout, "float32")
    assert pout["mfcc"].shape == (75, 13)
    nb = P.extract(x, 16000, which=("mfcc",), bucket=False, device="cpu")
    assert rel(nb["mfcc"], jout["mfcc"]) <= 1e-5
    assert P.extract(x[:100], 16000, which=("ssc", "energy"), device="cpu")["ssc"].shape == (0, 40)


def _total(out):
    """One scalar of every head (SSC, in Hz, scaled down to the others)."""
    parts = []
    for k in sorted(out):
        if k == "mfe":
            parts += [out[k][0].sum(), out[k][1].sum()]
        else:
            parts.append(out[k].sum() * (1e-3 if k == "ssc" else 1.0))
    return sum(parts)


@pytest.mark.parametrize("fn", ["ssc", "extract"])
def test_grads_match_jax(fn):
    jcfg, pcfg, jx, px = _pair({"preemphasis_cof": 0.97}, 3000, "float64", seed=9)
    if fn == "ssc":
        pfn, jfn = (lambda s: PF.ssc(s, pcfg).sum()), (lambda s: JF.ssc(s, jcfg).sum())
    else:
        pfn = lambda s: _total(PF.extract(s, pcfg, HEADS))
        jfn = lambda s: _total(JF.extract(s, jcfg, HEADS))
    a = px.clone().requires_grad_(True)
    pfn(a).backward()
    assert rel(a.grad, jax.grad(jfn)(jx)) <= 1e-5
