"""The port's export layer (``mfcc_rust_tpu_torch.export``) on the CPU, and
the repair of the tensor caches that a trace used to poison.

Each feature the JAX package's export reaches is exported by both
packages on the same seeded (2, 8000) input: the port's ``.pt2`` artifact,
loaded back, is held to the eager port at max|d|/max|ref| <= 1e-6 and to
the JAX package's deserialized artifact at the tolerance the port's tests
hold that feature to in float32: 1e-5 (mfcc, mfe, ssc, the vorbis mel),
3e-5 (lmfe), rtol 1e-4 and atol 1e-6 (the librosa mel and MFCC); 1e-9 in
float64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

import mfcc_rust_tpu as m
from mfcc_rust_tpu import export as jexport

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import constants as pconst
from mfcc_rust_tpu_torch import export as pexport
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import fft as pfft
from mfcc_rust_tpu_torch.ops import resample as presample
from mfcc_rust_tpu_torch.utils import profiling as prof

SHAPE = (2, 8000)
# feature -> (JAX config, tolerance kind)
FEATURES = {
    "mfcc": (m.speechpy_config(16000), "rel"),
    "mfe": (m.speechpy_config(16000), "rel"),
    "lmfe": (m.speechpy_config(16000), "log"),
    "ssc": (m.speechpy_config(16000), "rel"),
    "mel_spectrogram": (m.vorbis_config(16000), "rel"),
    "mel_spectrogram_librosa": (m.librosa_config(22050), "allclose"),
    "mfcc_librosa": (m.librosa_config(22050), "allclose"),
}
CASES = [(f, "float32") for f in FEATURES] + [("mfcc", "float64")]


def _signal(dtype, seed=40):
    return np.random.default_rng(seed).normal(0, 0.1, SHAPE).astype(dtype)


def _leaves(out):
    return [np.asarray(o, dtype=np.float64) for o in (out if isinstance(out, tuple) else (out,))]


def rel(a, ref) -> float:
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pcfg(jcfg, dtype):
    return P.from_reference(dataclasses.asdict(jcfg.replace(dtype=dtype)))


class _Call(torch.nn.Module):
    """A module whose forward calls one function: a trace of it reaches the
    function's caches directly, past any pipeline's buffers."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


TENSOR_CACHES = [PF._speechpy_tensors, PF._vorbis_tensors, PF._librosa_tensors,
                 PF._ct_mel_tensors, pconst.bundle_tensor, pfft._ct_tensors,
                 presample._wall_tensor]


def test_export_leaves_eager_calls_real():
    """Exports from cold caches leave every later eager call real.

    Before the repair, a trace that built a constant tensor stored it in the
    port's ``functools.lru_cache``s while the trace's fake mode was on: a
    ``FakeTensor`` in ``features._vorbis_tensors`` (the vorbis mel),
    ``features._librosa_tensors`` (the librosa mel at 512/160),
    ``features._ct_mel_tensors`` and ``ops.fft._ct_tensors`` (at 2048/512)
    and ``constants.bundle_tensor`` (the librosa MFCC's DCT).  Every eager
    call of that feature in the process then computed on the cached
    ``FakeTensor`` and returned one; reading it raised
    ``GuardOnDataDependentSymNode``.  The caches now build and store
    nothing while a trace runs (``constants.tensor_cache``)."""
    x = torch.from_numpy(_signal(np.float32))
    off = dict(pallas="off")
    calls = {
        "vorbis mel": lambda s: PF.mel_spectrogram(s, P.vorbis_config(16000)),
        "librosa mel 512/160": lambda s: PF.mel_spectrogram_librosa(
            s, P.librosa_config(16000, n_fft=512, hop_length=160, **off)),
        "librosa mel 2048/512": lambda s: PF.mel_spectrogram_librosa(
            s, P.librosa_config(22050, **off)),
        "librosa mfcc": lambda s: PF.mfcc_librosa(s, P.librosa_config(22050, **off)),
        "speechpy mfcc": lambda s: PF.mfcc(s, P.speechpy_config(16000, **off)),
        "resample": lambda s: presample.resample_poly(s, 2, 1),
    }
    before = {name: fn(x) for name, fn in calls.items()}
    for cache in TENSOR_CACHES:
        cache.cache_clear()
    for fn in calls.values():
        torch.export.export(_Call(fn), (x,))
    assert [c.cache_info().currsize for c in TENSOR_CACHES] == [0] * len(TENSOR_CACHES)
    for cfg, feature in ((P.vorbis_config(16000), "mel_spectrogram"),
                         (P.librosa_config(22050), "mel_spectrogram_librosa")):
        for cache in TENSOR_CACHES:
            cache.cache_clear()
        pexport.export_pipeline(cfg, feature, SHAPE, device="cpu")
    for cache in TENSOR_CACHES:
        cache.cache_clear()
    for fn in calls.values():  # a trace finds cached real tensors, and stores nothing
        fn(x)
        torch.export.export(_Call(fn), (x,))
    for name, fn in calls.items():
        out = fn(x)
        assert type(out) is torch.Tensor and not isinstance(out, FakeTensor), name
        assert torch.equal(out, before[name]), name


@pytest.mark.parametrize("feature,dtype", CASES, ids=[f"{f}-{d}" for f, d in CASES])
def test_exported_artifact_matches_eager_and_jax(feature, dtype, tmp_path):
    jcfg, kind = FEATURES[feature]
    pcfg = _pcfg(jcfg, dtype)
    x = _signal(dtype)
    path = tmp_path / f"{feature}.pt2"
    pexport.export_pipeline(pcfg, feature, SHAPE, path=str(path), device="cpu")
    assert path.stat().st_size > 0
    loaded = pexport.load_pipeline(str(path), device="cpu")
    got = _leaves(loaded(torch.from_numpy(x)))
    eager = _leaves(getattr(PF, feature)(torch.from_numpy(x), pcfg))
    assert [g.shape for g in got] == [e.shape for e in eager]
    for g, e in zip(got, eager):
        assert rel(g, e) <= 1e-6, feature

    jpath = tmp_path / f"{feature}.jaxexport"
    jexport.export_pipeline(jcfg.replace(dtype=dtype), feature, SHAPE, path=str(jpath))
    ref = _leaves(jexport.load_pipeline(str(jpath))(jnp.asarray(x)))
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        if dtype == "float64":
            assert rel(g, r) <= 1e-9, feature
        elif kind == "allclose":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
        else:
            assert rel(g, r) <= (3e-5 if kind == "log" else 1e-5), feature


def test_export_holds_constants_as_buffers():
    ep = pexport.export_pipeline(P.librosa_config(22050), "mfcc_librosa", SHAPE, device="cpu")
    assert {n for n, _ in ep.named_buffers()} >= {"window", "proj", "st1", "a", "b", "dct"}
    assert "lift_fresh_copy" not in str(ep.graph_module.code)
    assert ep.example_inputs is None  # the saved artifact holds no input batch


def test_graph_text_is_products_without_fft():
    txt = pexport.graph_text(P.speechpy_config(16000), "mfcc", (1, 8000), device="cpu")
    assert "matmul" in txt
    assert "fft" not in txt


def test_flops_estimate_counts_the_model_products():
    cfg = P.speechpy_config(16000)
    fl = pexport.flops_estimate(cfg, "mfcc", (1, 16000), device="cpu")
    assert fl is not None
    flops, _ = prof.kernel_work(cfg, "mfcc", 1, 16000, device_type="cpu")
    assert prof.work(cfg, "mfcc", 1, 16000, "cpu")["lowering"] == "chunk-gemm"
    assert abs(fl - flops) <= 0.05 * flops, (fl, flops)


@pytest.mark.parametrize("pipe,cfg,feature", [
    (P.MFCCPipeline, P.speechpy_config(16000), "mfcc"),
    (P.LibrosaMelPipeline, P.librosa_config(22050), "mel_spectrogram_librosa"),
], ids=["mfcc", "librosa"])
def test_pipeline_lower_is_export_pipeline(pipe, cfg, feature):
    x = torch.from_numpy(_signal(np.float32))
    ep = pipe(cfg, device="cpu").lower(SHAPE)
    ref = pexport.export_pipeline(cfg, feature, SHAPE, device="cpu")
    assert str(ep.graph_module.code) == str(ref.graph_module.code)
    assert torch.equal(ep.module()(x), ref.module()(x))
    ep64 = pipe(cfg, device="cpu").lower(SHAPE, torch.float64)
    assert ep64.module()(x.double()).dtype == torch.float64


def test_export_refuses_an_unknown_feature():
    with pytest.raises(ValueError, match="unknown feature"):
        pexport.export_pipeline(P.speechpy_config(16000), "plp", SHAPE, device="cpu")
