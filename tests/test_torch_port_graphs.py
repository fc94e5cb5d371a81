"""The port's compiled-call layer, ``mfcc_rust_tpu_torch.utils.graphs`` (a
CUDA-graph replay cache, the counterpart of ``api._jitted`` and
``Pipeline._jit``), on the CPU.

A CUDA graph needs a card, so here a stand-in whose "replay" recomputes the
captured function into its static outputs takes the graph's place (the
``replayed`` fixture) while everything around it is the real layer: the
key, the LRU, the static input that ``api`` fills (the upload, the bucket's
tail, the librosa centre pad's edges), the fresh copies, the launch counts
taken back from a capture and added per replay, the tensor-cache values a
graph keeps, and the eager rule
evaluated as for a CUDA device.  Through it, every entry point that the JAX
package jits and every pipeline is held to the JAX package on seeded numpy
inputs, two calls of different lengths in one bucket each, at the
tolerances of ``tests/test_torch_port_api.py`` (max|Δ|/max|ref| <= 1e-5,
3e-5 for log-mel heads and the librosa MFCC) and
``tests/test_torch_port_librosa.py`` (rtol 1e-4, atol 1e-6 for the librosa
mel and log-mel in float32).  The replay on the card is
held to the eager call in ``tests/test_torch_port_cuda.py``."""

import contextlib
import functools

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
import mfcc_rust_tpu.models as jm
from tests.golden import speechpy_ref

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import constants as pc
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch import transforms as T
from mfcc_rust_tpu_torch.models import pipelines as PP
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2
from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as kn
from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ke
from mfcc_rust_tpu_torch.ops.cuda import speechpy_heads as kh
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as kw
from mfcc_rust_tpu_torch.utils import bucketing, graphs
from mfcc_rust_tpu_torch.utils.bucketing import bucket_length

CUDA0 = torch.device("cuda", 0)


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for a, b in zip(dst, src):
            _copy_into(a, b)


class _FakeGraph:
    """A CUDA graph's stand-in on the CPU: a replay recomputes the captured
    function into the static outputs, on the state tensors it was captured
    with, and, as a graph replay, runs no wrapper (the counts it would make
    are put back)."""

    def __init__(self, fn, static, out, state=()):
        self.fn, self.static, self.out, self.state = fn, static, out, state
        self.replays = 0

    def replay(self):
        kernels = graphs._kernels()
        counts = graphs._counts(kernels)
        _copy_into(self.out, self.fn(self.static, *self.state))
        for k, c in zip(kernels, counts):
            if hasattr(k, "launches"):
                k.launches = c
        self.replays += 1


class FakeCache(graphs.GraphCache):
    """The real cache with the CUDA steps replaced: the warm-up is a plain
    call, the capture records a :class:`_FakeGraph` (``capturing`` is True
    meanwhile) and, as a capture executes nothing, leaves the state as it
    found it; the cache's stream is the CPU's one order."""

    capturing = False

    def _warm_up(self, fn, static, state=()):
        return fn(static, *state)

    def _record(self, fn, static, state=()):
        saved = [t.clone() for t in state]
        self.capturing = True
        try:
            out = fn(static, *state)
        finally:
            self.capturing = False
            for t, v in zip(state, saved):
                t.copy_(v)
        return _FakeGraph(fn, static, out, state), out

    def _on_cache_stream(self, device):
        return contextlib.nullcontext()


def _run(key, fn, x):
    """``fn`` on ``x`` through the cache, as ``Pipeline.forward`` calls it."""
    return graphs.cache.run(key, fn, x.shape, x.dtype, x.device, lambda s: s.copy_(x))


@pytest.fixture
def replayed(monkeypatch):
    """Route the calls through a :class:`FakeCache` with the eager rule as it
    reads for a CUDA device."""
    cache = FakeCache()
    real = graphs.runs_eagerly
    monkeypatch.setattr(graphs, "cache", cache)
    monkeypatch.setattr(graphs, "runs_eagerly", lambda x, device: real(x, CUDA0))
    return cache


# ------------------------------------------------------------------ the key --
def test_key_holds_function_config_shape_dtype_device_and_mode():
    cfg = P.speechpy_config(16000)
    key = graphs.GraphCache.key
    base = key((PF.mfcc, cfg), (2, 4096), torch.float32, CUDA0)
    assert base == key((PF.mfcc, cfg), torch.Size([2, 4096]), torch.float32, CUDA0)
    assert hash(base) == hash(key((PF.mfcc, cfg), (2, 4096), torch.float32, CUDA0))
    others = [
        key((PF.lmfe, cfg), (2, 4096), torch.float32, CUDA0),
        key((PF.mfcc, cfg.replace(num_cepstral=20)), (2, 4096), torch.float32, CUDA0),
        key((PF.mfcc, cfg), (2, 5120), torch.float32, CUDA0),
        key((PF.mfcc, cfg), (3, 4096), torch.float32, CUDA0),
        key((PF.mfcc, cfg), (2, 4096), torch.float64, CUDA0),
        key((PF.mfcc, cfg), (2, 4096), torch.float32, torch.device("cuda", 1)),
    ]
    with torch.inference_mode():
        others.append(key((PF.mfcc, cfg), (2, 4096), torch.float32, CUDA0))
    assert len({base, *others}) == len(others) + 1


def test_pipeline_key_holds_its_buffers(replayed):
    cfg = P.speechpy_config(16000)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (2, 4000)).astype(np.float32))
    a, b = P.MFCCPipeline(cfg, device="cpu"), P.MFCCPipeline(cfg, device="cpu")
    a(x), a(x), b(x)
    assert (replayed.captures, replayed.replays, len(replayed)) == (2, 1, 2)
    g = next(iter(replayed._graphs.values()))
    assert set(g.keep[0]) == {n for n, _ in a.named_buffers()}


# ------------------------------------------------------------------ the LRU --
def test_lru_holds_sixteen_as_the_jax_jit_cache():
    assert graphs.MAXSIZE == 16 == japi._jitted.cache_info().maxsize
    assert graphs.cache.maxsize == graphs.MAXSIZE


def test_lru_evicts_the_least_recently_used_at_sixteen():
    cache = FakeCache()
    fill = lambda s: s.fill_(1.0)
    run = lambda i: cache.run(("f", i), lambda s: s * i, (4,), torch.float32,
                              torch.device("cpu"), fill)
    for i in range(16):
        assert torch.equal(run(i), torch.full((4,), float(i)))
    assert (len(cache), cache.captures, cache.replays) == (16, 16, 0)
    run(0)  # now the most recently used: key 1 goes first
    run(16)
    assert (len(cache), cache.captures, cache.replays) == (16, 17, 1)
    run(0)
    assert cache.captures == 17
    run(1)  # evicted: captured again, evicting key 2
    assert (len(cache), cache.captures) == (16, 18)
    run(2)
    assert cache.captures == 19
    cache.clear()
    assert len(cache) == 0


# ---------------------------------------------------------- the eager rule --
def test_runs_eagerly_on_the_cpu_and_for_inputs_needing_a_gradient():
    x = torch.zeros(8)
    assert graphs.runs_eagerly(x, torch.device("cpu"))
    assert not graphs.runs_eagerly(x, CUDA0)
    xg = x.clone().requires_grad_(True)
    assert graphs.runs_eagerly(xg, CUDA0)
    with torch.no_grad():
        assert not graphs.runs_eagerly(xg, CUDA0)
    with graphs.disabled():
        assert graphs.runs_eagerly(x, CUDA0)
    assert not graphs.runs_eagerly(x, CUDA0)


def test_runs_eagerly_inside_a_trace_or_an_enclosing_capture(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        assert graphs.runs_eagerly(torch.zeros(8), CUDA0)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert graphs.runs_eagerly(torch.zeros(8), CUDA0)


def test_entry_points_on_the_cpu_capture_nothing():
    x = np.random.default_rng(4).normal(0, 0.1, (2, 9000)).astype(np.float32)
    before = (graphs.cache.captures, graphs.cache.replays, len(graphs.cache))
    P.mfcc(x, 16000, device="cpu")
    P.extract(x, 16000, ("mfcc", "ssc"), device="cpu")
    P.mel_spectrogram_librosa(x, 16000, n_fft=512, hop_length=160, device="cpu")
    P.MFCCPipeline(P.speechpy_config(16000), device="cpu")(torch.from_numpy(x))
    assert (graphs.cache.captures, graphs.cache.replays, len(graphs.cache)) == before


@pytest.mark.parametrize("through", ["api", "pipeline", "transform"])
def test_inputs_needing_a_gradient_run_eagerly_with_autograd(replayed, through):
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 0.1, (2, 6000)).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    cfg = P.speechpy_config(16000)
    fn = {"api": lambda s: P.mfcc(s, 16000, device="cpu"),
          "pipeline": P.MFCCPipeline(cfg, device="cpu"),
          "transform": T.MFCC(sr=16000, n_fft=512, hop_length=160)}[through]
    out = fn(xg)
    out.sum().backward()
    assert replayed.captures == 0 and xg.grad is not None
    assert bool(torch.isfinite(xg.grad).all()) and float(xg.grad.abs().max()) > 0
    with torch.no_grad():  # the same input needs no gradient here: a graph
        assert torch.equal(fn(xg), out.detach())
    assert replayed.captures == 1


# ----------------------------------------------------------- tensor caches --
def test_tensor_cache_stores_nothing_while_a_graph_is_captured(monkeypatch):
    built = []

    @pc.tensor_cache(maxsize=4)
    def make(n):
        built.append(n)
        return torch.zeros(n)

    one = make(1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert pc._capturing()
    assert make(1) is one  # what the warm-up stored is read
    two = make(2)
    assert make(2) is not two and built == [1, 2, 2]
    assert make.cache_info().currsize == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert make(2) is make(2) and built == [1, 2, 2, 2]
    info = make.cache_info()
    assert (info.hits, info.misses, info.maxsize, info.currsize) == (2, 4, 4, 2)
    make.cache_clear()
    assert make.cache_info() == pc.CacheInfo(0, 0, 4, 0)


def test_tensor_cache_is_an_lru_of_its_size():
    @pc.tensor_cache(maxsize=2)
    def make(n, scale=1.0):
        return torch.full((1,), n * scale)

    a = make(1)
    make(2)
    assert make(1) is a  # 1 is now the most recent: 2 goes first
    make(3)
    assert make(1) is a and make.cache_info().currsize == 2
    assert make(2, scale=2.0) is make(2, scale=2.0)
    assert float(make(2, scale=2.0)) == 4.0


def test_holding_keeps_every_value_a_tensor_cache_returns_on_its_thread(monkeypatch):
    import threading

    @pc.tensor_cache(maxsize=1)
    def make(n):
        return (torch.full((1,), float(n)), n)

    a = make(1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pc.holding() as held:
        assert make(1) is a  # a hit
        b = make(2)  # a miss, not stored while capturing
        with pc.holding() as inner:
            make(1)
        other = threading.Thread(target=make, args=(3,))  # another thread holds nothing here
        other.start()
        other.join()
    assert [v is w for v, w in zip(held, (a, b))] == [True, True] and len(held) == 2
    assert len(inner) == 1 and inner[0] is a
    make(1)
    assert len(held) == 2  # closed


def test_tensor_cache_is_safe_across_threads():
    """Threads switching every microsecond on a cache of two with five keys:
    every call gets its own key's value and the store stays in bounds."""
    import sys
    import threading

    @pc.tensor_cache(maxsize=2)
    def make(n):
        return torch.full((2,), float(n))

    errors = []

    def work(i):
        try:
            for j in range(300):
                n = (i + j) % 5
                if float(make(n)[0]) != n:
                    errors.append((i, j))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    info = make.cache_info()
    assert info.currsize <= 2 and info.hits + info.misses == 8 * 300


# --------------------------------------------------- the layer's mechanics --
def test_launches_count_per_replay_and_captures_count_none(replayed):
    """A capture's counts are taken back and added per replay: the first
    call counts its warm-up's launch, each later call its replay's: K1's,
    K2's (and K2's by path and its staged reflections), the speechpy edge
    sums', the speechpy heads', the Whisper finish's and the NeMo
    prologue's and finish's counters alike."""
    def fn(s):
        k1.mfcc_fused.launches += 1  # as the wrapper counts a launch
        ke.edge_sums.launches += 2
        kh.heads.launches += 3
        kw.whisper_logmel.launches += 2
        kn.nemo_prologue.launches += 1
        kn.nemo_finish.launches += 2
        k2.ct_mel.launches += 1
        k2.path_launches[3].launches += 1
        k2.reflect_launches.launches += 1
        return s * 2.0

    k1.mfcc_fused.launches = k2.ct_mel.launches = ke.edge_sums.launches = kh.heads.launches = 0
    kw.whisper_logmel.launches = kn.nemo_prologue.launches = kn.nemo_finish.launches = 0
    for c in (*k2.path_launches.values(), k2.reflect_launches):
        c.launches = 0
    x = torch.ones(4)
    for calls in (1, 2, 3):
        out = _run(("double",), fn, x)
        assert torch.equal(out, torch.full((4,), 2.0))
        assert (k1.mfcc_fused.launches, k2.ct_mel.launches, ke.edge_sums.launches,
                kh.heads.launches, kw.whisper_logmel.launches, kn.nemo_prologue.launches,
                kn.nemo_finish.launches) == (calls, calls, 2 * calls, 3 * calls, 2 * calls,
                                             calls, 2 * calls)
        assert k2.path_counts() == {1: 0, 2: 0, 3: calls}
        assert k2.reflect_launches.launches == calls
    (g,) = replayed._graphs.values()
    assert g.launches == (1, 1, 2, 3, 2, 1, 2, 0, 0, 1, 1) and g.graph.replays == 2
    k1.mfcc_fused.launches = k2.ct_mel.launches = ke.edge_sums.launches = kh.heads.launches = 0
    kw.whisper_logmel.launches = kn.nemo_prologue.launches = kn.nemo_finish.launches = 0
    k2.path_launches[3].launches = k2.reflect_launches.launches = 0


def test_a_failed_capture_raises_and_keeps_nothing(replayed):
    def fn(s):
        k2.ct_mel.launches += 1
        if replayed.capturing:
            raise RuntimeError("operation not permitted when stream is capturing")
        return s + 1.0

    k2.ct_mel.launches = 0
    with pytest.raises(RuntimeError, match="capturing"):
        _run(("fails",), fn, torch.zeros(3))
    assert len(replayed) == 0 and replayed.captures == 0
    assert k2.ct_mel.launches == 1  # the warm-up's, none of the capture's
    k2.ct_mel.launches = 0


def test_a_graph_keeps_the_tensor_cache_values_its_capture_read(replayed):
    """A graph reads the constants at the addresses it captured: it keeps
    them, whatever the tensor caches evict later."""
    @pc.tensor_cache(maxsize=1)
    def const(n):
        return torch.full((3,), float(n))

    fn = lambda s: s * const(2)
    first = _run(("scaled",), fn, torch.ones(3))
    c = const(2)
    (g,) = replayed._graphs.values()
    assert any(v is c for v in g.keep[1])
    const.cache_clear()
    const(5)
    assert const(2) is not c and any(v is c for v in g.keep[1])
    assert torch.equal(_run(("scaled",), fn, torch.full((3,), 3.0)), torch.full((3,), 6.0))
    assert torch.equal(first, torch.full((3,), 2.0))


def test_results_outlive_the_next_call(replayed):
    fn = lambda s: s * 3.0
    a = _run(("triple",), fn, torch.ones(2))
    b = _run(("triple",), fn, torch.full((2,), 2.0))
    c = _run(("triple",), fn, torch.full((2,), 5.0))
    assert [float(t.sum()) for t in (a, b, c)] == [6.0, 12.0, 30.0]
    (g,) = replayed._graphs.values()
    assert b.data_ptr() != g.out.data_ptr() != c.data_ptr()


def test_tree_outputs_come_back_as_fresh_copies(replayed):
    fn = lambda s: {"a": s + 1.0, "b": (s * 2.0, s.sum(-1))}
    first = _run(("tree",), fn, torch.ones(2, 3))
    again = _run(("tree",), fn, torch.ones(2, 3))
    assert first.keys() == again.keys() and isinstance(again["b"], tuple)
    assert torch.equal(again["b"][1], torch.full((2,), 3.0))


def test_threads_share_the_cache_without_capturing_twice(replayed):
    """Many threads calling at once, switching every microsecond: each key
    is captured once and every call returns its own input's result."""
    import sys
    import threading

    fn = lambda s: s * 2.0
    errors = []

    def work(i):
        try:
            for j in range(30):
                x = torch.full((3,), float(i * 100 + j))
                out = _run(("t", (i + j) % 3), fn, x)
                if not torch.equal(out, x * 2.0):
                    errors.append((i, j))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert (replayed.captures, replayed.replays) == (3, 12 * 30 - 3)


# ---------------------------------------- entry points through the layer --
def _close_librosa(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-6)


def _rel_check(tol):
    return lambda got, ref: rel(got, ref) <= tol or pytest.fail(f"{rel(got, ref)} > {tol}")


# (entry point, args after the input, keywords, the two lengths of one
# bucket, check against JAX)
API_CALLS = [
    ("mfcc", (16000,), {}, (15000, 13000), _rel_check(1e-5)),
    ("mfcc", (16000,), {"num_cepstral": 20, "frame_length": 0.025}, (9000, 8300),
     _rel_check(1e-5)),
    ("lmfe", (16000,), {"frame_length": 0.025}, (15000, 13000), _rel_check(3e-5)),
    ("ssc", (16000,), {}, (15000, 13000), _rel_check(1e-5)),
    ("ssc", (16000,), {"frame_length": 0.025, "num_filters": 26}, (15000, 13000),
     _rel_check(1e-5)),
    ("mel_spectrogram", (16000,), {}, (15000, 13000), _rel_check(1e-5)),
    ("mel_spectrogram_librosa", (), {}, (21000, 20000), _close_librosa),
    ("mel_spectrogram_librosa", (), {"bucket": False}, (23000, 23000), _close_librosa),
    ("mel_spectrogram_librosa", (), {"sr": 16000, "n_fft": 512, "hop_length": 160},
     (900, 300), _close_librosa),
    ("mel_spectrogram_librosa", (), {"center": False, "sr": 16000, "n_fft": 512},
     (9000, 8500), _close_librosa),
    ("log_mel_spectrogram", (16000,), {"n_fft": 512, "hop_length": 160, "n_mels": 80},
     (23000, 21000), _close_librosa),
    ("mfcc_librosa", (), {"n_mfcc": 13}, (21000, 20000), _rel_check(3e-5)),
    ("mfcc_librosa", (), {"n_mfcc": 13, "center": False}, (23000, 21000),
     _rel_check(3e-5)),
]


def _bucketed_length(name, kw, n):
    if kw.get("bucket", True) is False:
        return n
    if name in ("mel_spectrogram_librosa", "log_mel_spectrogram", "mfcc_librosa") \
            and kw.get("center", True):
        return bucket_length(n + 2 * (kw.get("n_fft", 2048) // 2))
    return bucket_length(n)


@pytest.mark.parametrize("name,args,kw,lengths,check", API_CALLS,
                         ids=[f"{c[0]} {c[2]}" for c in API_CALLS])
def test_entry_points_through_the_layer_match_jax(replayed, name, args, kw, lengths, check):
    """The first call captures, the second replays on a shorter signal of
    the same bucket: each matches the JAX entry point, so the static
    input's tail and the centre pad's edges were written afresh."""
    rng = np.random.default_rng(6)
    n1, n2 = lengths
    assert _bucketed_length(name, kw, n1) == _bucketed_length(name, kw, n2)
    for n in (n1, n2):
        x = rng.normal(0, 0.1, (2, n)).astype(np.float32)
        got = getattr(P, name)(x, *args, **kw, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        check(got, getattr(japi, name)(x, *args, **kw))
        # and equal to the eager call (the same writer into a fresh input), bit for bit
        with graphs.disabled():
            assert torch.equal(got, getattr(P, name)(x, *args, **kw, device="cpu"))
    assert (replayed.captures, replayed.replays) == (1, 1)


def test_mfe_and_extract_through_the_layer_match_jax(replayed):
    rng = np.random.default_rng(7)
    which = ("mfe", "energy", "mfcc", "lmfe", "ssc")
    for n in (15000, 13000):
        x = rng.normal(0, 0.1, (2, n)).astype(np.float32)
        pf, pe = P.mfe(x, 16000, device="cpu")
        jf, je = japi.mfe(x, 16000)
        assert rel(pf, jf) <= 1e-5 and rel(pe, je) <= 1e-5
        got = P.extract(x, 16000, which=which, device="cpu")
        ref = japi.extract(x, 16000, which=which)
        assert got.keys() == ref.keys()
        for k in got:
            a, b = (got[k], ref[k]) if k != "mfe" else (got[k][0], ref[k][0])
            assert rel(a, b) <= (3e-5 if k == "lmfe" else 1e-5), k
        assert rel(got["mfe"][1], ref["mfe"][1]) <= 1e-5
    # mfe and extract: one graph each, replayed once
    assert (replayed.captures, replayed.replays) == (2, 2)
    other = P.extract(x, 16000, which=("mfcc",), device="cpu")  # another head set
    assert replayed.captures == 3 and rel(other["mfcc"], ref["mfcc"]) <= 1e-5


def test_numpy_and_tensor_inputs_of_other_dtypes_fill_alike(replayed):
    x = np.random.default_rng(8).normal(0, 0.1, 15000)
    ref = japi.mfcc(x.astype(np.float32), 16000)
    for inp in (x, x.astype(np.float32), torch.from_numpy(x), list(x[:20]) + list(x[20:])):
        assert rel(P.mfcc(inp, 16000, device="cpu"), ref) <= 1e-5
    pcm = (x * 3000).astype(np.int16)
    assert rel(P.mfcc(pcm, 16000, device="cpu"), japi.mfcc(pcm, 16000)) <= 1e-5


def test_short_clips_through_the_layer_fold_the_centre_pad_as_numpy(replayed):
    """Clips shorter than n_fft / 2 reflect again and again; the edges
    written into the static input read the same folded samples."""
    rng = np.random.default_rng(9)
    for n in (1, 5, 100, 1023, 1500):
        x = rng.normal(0, 0.1, n).astype(np.float32)
        _close_librosa(P.mel_spectrogram_librosa(x, device="cpu"),
                       japi.mel_spectrogram_librosa(x))
    with pytest.raises(ValueError, match="empty"):
        P.mel_spectrogram_librosa(np.zeros(0, np.float32), device="cpu")


PIPELINES = [
    ("MFCCPipeline", "speechpy_config", (16000,), {}, 1e-5),
    ("MFEPipeline", "speechpy_config", (16000,), {}, 1e-5),
    ("LogMFEPipeline", "speechpy_config", (16000,), {"frame_length": 0.025}, 3e-5),
    ("SSCPipeline", "speechpy_config", (16000,), {}, 1e-5),
    ("MelSpectrogramPipeline", "speechpy_config", (16000,), {}, 1e-5),
    ("LibrosaMelPipeline", "librosa_config", (22050,), {}, None),
    ("LibrosaMFCCPipeline", "librosa_config", (22050,), {}, 3e-5),
]


@pytest.mark.parametrize("name,preset,args,kw,tol", PIPELINES, ids=[c[0] for c in PIPELINES])
def test_pipelines_through_the_layer_match_jax(replayed, name, preset, args, kw, tol):
    cfg = getattr(P, preset)(*args, **kw)
    jcfg = getattr(m, preset)(*args, **kw)
    pipe = getattr(PP, name)(cfg, device="cpu")
    jpipe = getattr(jm, name)(jcfg)
    rng = np.random.default_rng(10)
    for _ in range(2):
        x = rng.normal(0, 0.1, (2, 12000)).astype(np.float32)
        got, ref = pipe(torch.from_numpy(x)), jpipe(x)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            if tol is None:
                _close_librosa(a, b)
            else:
                assert rel(a, b) <= tol
    assert (replayed.captures, replayed.replays) == (1, 1)


def test_feature_extractor_and_transforms_through_the_layer(replayed):
    cfg = P.speechpy_config(16000)
    fe = P.FeatureExtractor(cfg, device="cpu")
    jfe = jm.FeatureExtractor(m.speechpy_config(16000))
    tr = T.MelSpectrogram(sr=16000, n_fft=512, hop_length=160, n_mels=40)
    rng = np.random.default_rng(11)
    for _ in range(2):
        x = rng.normal(0, 0.1, (2, 8000)).astype(np.float32)
        assert rel(fe(torch.from_numpy(x)), jfe(x)) <= 1e-5
        assert rel(fe.ssc(torch.from_numpy(x)), jfe.ssc(x)) <= 1e-5
        _close_librosa(tr(torch.from_numpy(x)),
                       japi.mel_spectrogram_librosa(x, 16000, n_fft=512, hop_length=160,
                                                    n_mels=40))
    assert (replayed.captures, replayed.replays) == (3, 3)


# ---------------------------------------------- one launch of K1, no graph --
# ``api.mfcc`` whose lowering is K1 alone launches it on the caller's signal
# at its true length, through no graph.  Here the lowering reads as for a
# CUDA float32 tensor (``k1_lowering``), so the MFCC's lowering is "k1" and
# ``mfcc_fused`` runs its plain version on the CPU tensor.


@pytest.fixture
def k1_lowering(monkeypatch):
    """``features.speechpy_lowering`` as it reads on a CUDA device, and
    fresh path and pad counters."""
    real = PF.speechpy_lowering
    monkeypatch.setattr(PF, "speechpy_lowering",
                        lambda cfg, feature="mfcc", device_type="cuda",
                        dtype=torch.float32: real(cfg, feature, "cuda", dtype))
    monkeypatch.setattr(PA, "paths", PA.PathCount())
    monkeypatch.setattr(bucketing, "samples", bucketing.SampleCount())
    return monkeypatch


def _base(n):
    """A (6, n) seeded batch."""
    return np.random.default_rng(n).normal(0, 0.1, (6, n)).astype(np.float32)


# the input's shape from the (6, n) batch
DIMS = {"1-D": (lambda a: a[0]), "2-D": (lambda a: a[:2]),
        "3-D": (lambda a: a.reshape((2, 3) + a.shape[1:]))}


def _oracle(x):
    """The float64 speechpy oracle's MFCC of each row of ``x``."""
    rows = x.reshape(-1, x.shape[-1]).astype(np.float64)
    out = np.stack([np.asarray(speechpy_ref.mfcc(r, 16000)).reshape(-1, 13) for r in rows])
    return out.reshape(x.shape[:-1] + out.shape[1:])


@pytest.mark.parametrize("bucket", [True, False], ids=["bucket", "no-bucket"])
@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("n", [16000, 15999, 13001, 300])
def test_mfcc_of_one_k1_launch_runs_in_place_through_no_graph(replayed, k1_lowering, n,
                                                              dims, bucket):
    """No capture, no replay, no bucket: one ``direct`` call and n true and
    bucketed samples a row, a call.  The answer is the eager (bucketed)
    call's, bit for bit, within 1e-5 of the float64 oracle, and within 1e-5
    of JAX's ``api.mfcc`` unless JAX's float32 answer lies further from the
    oracle (on a frame whose DC term nearly cancels, JAX sums it in float32
    where K1 and its plain version sum it in float64)."""
    x = DIMS[dims](_base(n))
    rows = x.size // n
    for call in range(1, 3):
        got = P.mfcc(torch.from_numpy(x), 16000, bucket=bucket, device="cpu")
        assert got.dtype == torch.float32
        assert tuple(got.shape) == x.shape[:-1] + (PA._frames_nopad(PA._speechpy_cfg(16000),
                                                                    n), 13)
        assert (replayed.captures, replayed.replays, len(replayed)) == (0, 0, 0)
        assert PA.paths.read() == {"direct": call, "graphed": 0, "eager": 0}
        assert bucketing.samples.read() == (call * rows * n, call * rows * n)
    with graphs.disabled():
        assert torch.equal(got, P.mfcc(torch.from_numpy(x), 16000, bucket=bucket, device="cpu"))
    oracle, ref = _oracle(x), np.asarray(japi.mfcc(x, 16000, bucket=bucket))
    assert rel(got, oracle) <= 1e-5
    assert rel(got, ref) <= 1e-5 or rel(ref, oracle) > rel(got, oracle)


# (case, entry point, the path it takes): each as before this path existed
NOT_DIRECT = [
    ("pallas off", "mfcc", "graphed"),
    ("needs a gradient", "mfcc", "eager"),
    ("graphs disabled", "mfcc", "eager"),
    ("empty signal", "mfcc", "graphed"),
    ("mfe", "mfe", "graphed"),
    ("ssc", "ssc", "graphed"),
]


@pytest.mark.parametrize("case,name,path", NOT_DIRECT, ids=[c[0] for c in NOT_DIRECT])
def test_calls_not_one_k1_launch_keep_their_path(replayed, k1_lowering, case, name, path):
    n = 0 if case == "empty signal" else 15000
    x = torch.from_numpy(np.random.default_rng(12).normal(0, 0.1, (2, n)).astype(np.float32))
    if case == "pallas off":
        real = PA._speechpy_cfg
        k1_lowering.setattr(PA, "_speechpy_cfg",
                            lambda *a, **k: real(*a, **k).replace(pallas="off"))
    inp = x.clone().requires_grad_(True) if case == "needs a gradient" else x
    with graphs.disabled() if case == "graphs disabled" else contextlib.nullcontext():
        got = getattr(P, name)(inp, 16000, device="cpu")
    assert PA.paths.read() == {"direct": 0, "graphed": 0, "eager": 0, path: 1}
    assert (replayed.captures, replayed.replays) == ((1, 0) if path == "graphed" else (0, 0))
    assert bucketing.samples.read() == (2 * n, 2 * bucket_length(n))
    ref = getattr(japi, name)(x.numpy(), 16000)
    got, ref = (got[0], ref[0]) if name == "mfe" else (got, ref)
    assert rel(got.detach(), ref) <= 1e-5


# ------------------------------------ the centre pad and one launch of K2 --
# ``api.mel_spectrogram_librosa`` whose lowering is K2 alone pads the
# caller's signal at its true length and launches K2 on it, through no graph.
# Here the lowering reads as for a CUDA float32 tensor (``k2_lowering``), so
# it is "k2" and ``ct_mel`` runs its plain version on the CPU tensor.


@pytest.fixture
def k2_lowering(monkeypatch):
    """``features.librosa_lowering`` as it reads on a CUDA device (through a
    fresh cache of ``api``'s), and fresh path and pad counters."""
    real = PF.librosa_lowering
    monkeypatch.setattr(PF, "librosa_lowering",
                        lambda cfg, device_type="cuda", dtype=torch.float32:
                        real(cfg, "cuda", dtype))
    monkeypatch.setattr(PA, "_librosa_lowering",
                        functools.lru_cache(maxsize=64)(PA._librosa_lowering.__wrapped__))
    monkeypatch.setattr(PA, "paths", PA.PathCount())
    monkeypatch.setattr(bucketing, "samples", bucketing.SampleCount())
    return monkeypatch


# (id, keywords, a length that fills a hop, one that does not): the two
# librosa cells' configurations
K2_CONFIGS = {
    "2048/512/128": ({"sr": 22050}, 8192, 8000),
    "512/160/80": ({"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 80}, 8000, 7919),
}


@pytest.mark.parametrize("center", [True, False], ids=["centred", "uncentred"])
@pytest.mark.parametrize("bucket", [True, False], ids=["bucket", "no-bucket"])
@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("fills", [True, False], ids=["whole-hops", "part-hop"])
@pytest.mark.parametrize("config", list(K2_CONFIGS))
def test_mel_spectrogram_librosa_of_one_k2_launch_runs_in_place_through_no_graph(
        replayed, k2_lowering, config, fills, dims, bucket, center):
    """No capture, no replay, no bucket: one ``direct`` call and the
    centre-padded length as its true and bucketed samples a row, a call.  The
    shape is librosa's frame count; the answer is the eager (bucketed) call's,
    bit for bit, and JAX's within the librosa tolerance."""
    kw, whole, part = K2_CONFIGS[config]
    n = whole if fills else part
    kw = dict(kw, center=center, bucket=bucket)
    x = DIMS[dims](_base(n))
    rows, n_fft = x.size // n, kw.get("n_fft", 2048)
    t = n + (2 * (n_fft // 2) if center else 0)
    frames = PA._stft.librosa_frame_count(n, n_fft, kw.get("hop_length", 512), center)
    for call in range(1, 3):
        got = P.mel_spectrogram_librosa(torch.from_numpy(x), **kw, device="cpu")
        assert got.dtype == torch.float32
        assert tuple(got.shape) == x.shape[:-1] + (kw.get("n_mels", 128), frames)
        assert (replayed.captures, replayed.replays, len(replayed)) == (0, 0, 0)
        assert PA.paths.read() == {"direct": call, "graphed": 0, "eager": 0}
        assert bucketing.samples.read() == (call * rows * t, call * rows * t)
    with graphs.disabled():
        assert torch.equal(got, P.mel_spectrogram_librosa(torch.from_numpy(x), **kw,
                                                          device="cpu"))
    _close_librosa(got, japi.mel_spectrogram_librosa(x, **kw))


# (entry point, keywords): the direct calls of K2 under a centred
# reflect-mode config, the two librosa cells' and Whisper's
K2_REFLECT_CALLS = [
    ("mel_spectrogram_librosa", {"sr": 22050}),
    ("mel_spectrogram_librosa", {"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 80}),
    ("log_mel_spectrogram_whisper", {"n_mels": 128}),
]


@pytest.mark.parametrize("n", [8000, 7919])
@pytest.mark.parametrize("name,kw", K2_REFLECT_CALLS, ids=["librosa128", "librosa80", "whisper"])
def test_direct_k2_calls_pad_nothing_before_the_kernel(replayed, k2_lowering, name, kw, n):
    """A direct K2 call hands K2 the caller's n samples and the centred
    reflect-mode config, with ``api``'s centre pad made to raise: K2 stages
    the pad itself (on the CPU its plain version pads).  It counts the
    centre-padded length, and its answer is the eager call's, bit for
    bit."""
    x = torch.from_numpy(_base(n)[:2])
    seen = []
    real = k2.ct_mel

    def spy(sig, cfg, used=None):
        seen.append((sig.shape[-1], cfg.center, cfg.pad_mode))
        return real(sig, cfg, used)

    def no_pad(sig, cfg):
        raise AssertionError("the signal was padded before K2")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k2, "ct_mel", spy)
        mp.setattr(PA._framing, "center_pad", no_pad)
        got = getattr(P, name)(x, **kw, device="cpu")
    assert seen == [(n, True, "reflect")]
    assert PA.paths.read() == {"direct": 1, "graphed": 0, "eager": 0}
    half = kw.get("n_fft", 400 if "whisper" in name else 2048) // 2
    assert bucketing.samples.read() == (2 * (n + 2 * half),) * 2
    with graphs.disabled():
        assert torch.equal(got, getattr(P, name)(x, **kw, device="cpu"))


def test_direct_k1_and_nemo_calls_keep_their_pads(replayed, k1_lowering, k2_lowering):
    """K1's direct call (uncentred) pads nothing and gets its config as it
    is; NeMo's hands its launcher the unpadded rows and the centred
    constant-mode config, and its prologue writes the zero pad (K2 then
    reads the padded rows uncentred).  Both count the samples their kernels
    frame."""
    seen = []
    real_nemo = kn.nemo_direct

    def spy(sig, lengths, cfg):
        seen.append((sig.shape[-1], cfg.pad_mode))
        return real_nemo(sig, lengths, cfg)

    k2_lowering.setattr(kn, "nemo_direct", spy)
    x = torch.from_numpy(_base(8000)[:2])
    P.log_mel_spectrogram_nemo(x, [8000, 5000], device="cpu")
    assert seen == [(8000, "constant")]
    P.mfcc(x, 16000, device="cpu")
    assert PA.paths.read() == {"direct": 2, "graphed": 0, "eager": 0}
    assert bucketing.samples.read() == (2 * (8000 + 512) + 2 * 8000,) * 2


# (case, entry point, keywords, length, the path it takes): each as before
# this path existed
K2_NOT_DIRECT = [
    ("pallas off", "mel_spectrogram_librosa", {}, 15000, "graphed"),
    ("needs a gradient", "mel_spectrogram_librosa", {}, 15000, "eager"),
    ("graphs disabled", "mel_spectrogram_librosa", {}, 15000, "eager"),
    ("n = n_fft/2", "mel_spectrogram_librosa", {}, 1024, "graphed"),
    ("n < n_fft/2", "mel_spectrogram_librosa", {"sr": 16000, "n_fft": 512}, 100, "graphed"),
    ("log_mel_spectrogram", "log_mel_spectrogram", {}, 15000, "graphed"),
    ("mfcc_librosa", "mfcc_librosa", {"n_mfcc": 13}, 15000, "graphed"),
]


@pytest.mark.parametrize("case,name,kw,n,path", K2_NOT_DIRECT,
                         ids=[c[0] for c in K2_NOT_DIRECT])
def test_librosa_calls_not_one_k2_launch_keep_their_path(replayed, k2_lowering, case, name, kw,
                                                         n, path):
    x = torch.from_numpy(np.random.default_rng(13).normal(0, 0.1, (2, n)).astype(np.float32))
    if case == "pallas off":
        real = PA._librosa_cfg
        k2_lowering.setattr(PA, "_librosa_cfg",
                            lambda *a, **k: real(*a, **k).replace(pallas="off"))
    inp = x.clone().requires_grad_(True) if case == "needs a gradient" else x
    with graphs.disabled() if case == "graphs disabled" else contextlib.nullcontext():
        got = getattr(P, name)(inp, **kw, device="cpu")
    assert PA.paths.read() == {"direct": 0, "graphed": 0, "eager": 0, path: 1}
    assert (replayed.captures, replayed.replays) == ((1, 0) if path == "graphed" else (0, 0))
    t = n + 2 * (kw.get("n_fft", 2048) // 2)
    assert bucketing.samples.read() == (2 * t, 2 * bucket_length(t))
    ref = getattr(japi, name)(x.numpy(), **kw)
    if name == "mfcc_librosa":
        assert rel(got.detach(), ref) <= 3e-5
    else:
        _close_librosa(got.detach(), ref)
