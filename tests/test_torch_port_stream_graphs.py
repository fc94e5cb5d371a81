"""The port's streaming sessions through their compiled calls, on the CPU.

On CUDA each session (``IncrementalFrontend``, the recompute path of
``StreamingFeatures``, ``StreamingExtractor``) replays CUDA graphs from a
``utils.graphs.GraphCache`` of its own, with the carry in session tensors
that a replay updates in place: the counterpart of the JAX sessions'
``jax.jit`` steps.  Here every session made under the ``replayed`` fixture
gets ``tests/test_torch_port_graphs.py``'s ``FakeCache`` (a "replay"
recomputes the captured function on the state tensors it was captured
with, a "capture" leaves the state as it found it) and the eager rule as it
reads for a CUDA device, so the real layer runs here: the buckets, the
fills, the per-session keys and LRU, the state carried in place.

The six sessions of ``chip_smoke.py``'s streaming phase (S1-S6) at a few
seconds of audio, each fed the same seeded ragged chunks as the JAX
session, at ``tests/test_torch_port_streaming.py``'s tolerances: float64
against JAX at rtol 1e-10, atol 1e-12; float32 within 5e-3 of max|ref| (the
reference's float32 gate).  The replayed rows must equal the port's own
eager rows bit for bit: both run the same pieces through the same
products."""

import dataclasses

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu.models import StreamingExtractor as JExtractor
from mfcc_rust_tpu.models import StreamingFeatures as JFeatures
from mfcc_rust_tpu.models import incremental as jinc

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures
from mfcc_rust_tpu_torch.models import incremental as pinc
from mfcc_rust_tpu_torch.utils import graphs
from tests.test_torch_port_graphs import CUDA0, FakeCache

F64 = {"rtol": 1e-10, "atol": 1e-12}
F32_REL = 5e-3

# name, JAX config, feature ("stft": StreamingExtractor), path
SESSIONS = [
    ("S1 mfcc 20/10", m.speechpy_config(16000), "mfcc", "carried"),
    ("S2 mfe 20/10", m.speechpy_config(16000), "mfe", "carried"),
    ("S3 mfcc 25/10", m.speechpy_config(16000, frame_length=0.025), "mfcc", "recompute"),
    ("S4 mel 2048/512", m.librosa_config(22050), "mel_librosa", "carried"),
    ("S5 mel 512/160/80", m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
     "mel_librosa", "recompute"),
    ("S6 extractor", m.vorbis_config(16000), "stft", "stft"),
]


def port_cfg(cfg):
    return P.from_reference(dataclasses.asdict(cfg))


def port_session(cfg, feature):
    """The port's session on the CPU."""
    if feature == "stft":
        return StreamingExtractor(port_cfg(cfg), device="cpu")
    return StreamingFeatures(port_cfg(cfg), feature=feature, device="cpu")


def make_pair(cfg, feature):
    """(the JAX session, the port's on the CPU)."""
    jsess = JExtractor(cfg) if feature == "stft" else JFeatures(cfg, feature=feature)
    return jsess, port_session(cfg, feature)


def hop_of(cfg, feature):
    return cfg.stream_hop if feature == "stft" else cfg.frame_step


def schedule(seed, cfg, feature, seconds=3.0):
    """Seeded ragged chunk sizes over ``seconds`` of audio: 1-4,000 samples
    (whole hops, 1-12, for the extractor), with an 85-hop chunk (plus 7
    samples off the extractor) early, so the carried step meets every
    ``K_BUCKETS`` size and the recompute path a large emission bucket."""
    rng = np.random.default_rng(seed)
    hop = hop_of(cfg, feature)
    total = int(seconds * cfg.sample_rate)
    sizes, n = [], 0
    while n < total:
        if len(sizes) == 3:
            size = 85 * hop + (0 if feature == "stft" else 7)
        elif feature == "stft":
            size = hop * int(rng.integers(1, 13))
        else:
            size = int(rng.integers(1, 4001))
        sizes.append(size)
        n += size
    return sizes


def chunks_of(seed, cfg, feature, dtype, seconds=3.0):
    sizes = schedule(seed, cfg, feature, seconds)
    x = np.random.default_rng(seed + 100).normal(0, 0.1, sum(sizes)).astype(dtype)
    ends = np.cumsum(sizes)
    return [x[e - n:e] for n, e in zip(sizes, ends)]


def feed(sess, chunks):
    return [sess.process(c) for c in chunks]


def leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def graph_cache(sess):
    """The session's own graph cache."""
    if isinstance(sess, StreamingFeatures) and sess._inc is not None:
        return sess._inc._graphs
    return sess._graphs


@pytest.fixture
def replayed(monkeypatch):
    """Sessions made inside get a :class:`FakeCache` each (the list returned
    holds them in order) and the eager rule as it reads for CUDA."""
    made = []

    def make(*args, **kw):
        made.append(FakeCache(*args, **kw))
        return made[-1]

    real = graphs.runs_eagerly
    monkeypatch.setattr(graphs, "GraphCache", make)
    monkeypatch.setattr(graphs, "runs_eagerly", lambda x, device: real(x, CUDA0))
    return made


def test_buckets_equal_the_jax_constants():
    assert pinc.IncrementalFrontend.K_BUCKETS == jinc.IncrementalFrontend.K_BUCKETS
    assert StreamingFeatures.EMIT_BUCKETS == JFeatures.EMIT_BUCKETS


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,cfg,feature,path", SESSIONS, ids=[c[0] for c in SESSIONS])
def test_replayed_sessions_match_jax_and_their_eager_rows(replayed, name, cfg, feature, path,
                                                          dtype):
    """Every return of the replayed session against the JAX session's, and
    bit for bit against the port's eager session's."""
    cfg = cfg.replace(dtype=dtype)
    chunks = chunks_of(1, cfg, feature, dtype)
    jsess, psess = make_pair(cfg, feature)
    with graphs.disabled():
        esess = port_session(cfg, feature)
    cache = graph_cache(psess)
    assert isinstance(cache, FakeCache) and cache is not graph_cache(esess)
    for c in chunks:
        ours, ref = psess.process(c), jsess.process(c)
        with graphs.disabled():
            eager = esess.process(c)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, e, r in zip(leaves(ours), leaves(eager), ref):
            assert torch.equal(a, e), name
            assert tuple(a.shape) == np.asarray(r).shape
            if a.numel() == 0:
                continue
            if dtype == "float64":
                np.testing.assert_allclose(a.numpy(), np.asarray(r), **F64)
            else:
                err = np.abs(a.numpy() - r).max() / np.abs(r).max()
                assert err <= F32_REL, (name, err)
    assert cache.captures >= 1 and cache.replays >= 1
    if feature == "stft":
        assert torch.equal(psess.finalize(), torch.from_numpy(jsess.finalize()))


@pytest.mark.parametrize("name,cfg,feature,path", SESSIONS, ids=[c[0] for c in SESSIONS])
def test_keys_are_bounded_by_the_buckets_and_captured_once(replayed, name, cfg, feature,
                                                          path):
    """A ragged schedule meets at most ``K_BUCKETS`` shapes on the carried
    path (the JAX front end's step sizes) and ``EMIT_BUCKETS`` lengths on
    the recompute path (plus a count above 1,024 as it is), captures each
    once, and replays every later call; the eager session runs the same
    pieces."""
    cfg = cfg.replace(dtype="float64")
    chunks = chunks_of(2, cfg, feature, "float64", seconds=6.0)
    if path == "recompute":
        chunks.append(np.zeros(1100 * cfg.frame_step, np.float64))  # 1,100 frames at once
    jsess, psess = make_pair(cfg, feature)
    cache = graph_cache(psess)
    shapes, eager_shapes = [], []

    def spy(sess, into, skip=lambda: False):
        """Record the input shape of each call of the session's step."""
        owner = sess._inc if path == "carried" else sess
        attr = "_step" if path == "carried" else "_batch"
        inner = getattr(owner, attr)

        def step(x, *state):
            if not skip():  # a capture records the piece the warm-up ran
                into.append(tuple(x.shape))
            return inner(x, *state)

        setattr(owner, attr, step)

    if path != "stft":
        with graphs.disabled():
            esess = port_session(cfg, feature)
        spy(esess, eager_shapes)
        spy(psess, shapes, lambda: cache.capturing)
    for c in chunks:
        psess.process(c)
        jsess.process(c)
        if path != "stft":
            with graphs.disabled():
                esess.process(c)
    keys = {k[1] for k in cache._graphs}
    assert cache.captures == len(cache) == len(keys)
    if path == "carried":
        hop = cfg.frame_step
        assert keys == {(k, hop) for k in jinc.IncrementalFrontend.K_BUCKETS}
        assert {k for k, _ in keys} == set(jsess._inc._steps)
    elif path == "recompute":
        hop, fl = cfg.frame_step, psess._frame_len()
        extra = fl - hop if feature == "mel_librosa" else fl
        counts = {(n - extra) // hop for (n,) in keys}
        assert counts <= set(StreamingFeatures.EMIT_BUCKETS) | {1100}
        assert 1100 in counts and len(counts) >= 5
    else:
        assert keys == {(n,) for n in map(len, chunks)}
    if path != "stft":
        # the eager session ran the same pieces, at the same shapes
        assert eager_shapes == shapes and len(shapes) == cache.captures + cache.replays


@pytest.mark.parametrize("name,cfg,feature,path",
                         [SESSIONS[i] for i in (0, 1, 5)], ids=[SESSIONS[i][0] for i in (0, 1, 5)])
def test_the_first_call_advances_the_carry_once(replayed, name, cfg, feature, path):
    """The first call of a key warms up once (the real first step) and
    records without executing: its carry equals the eager session's after
    the same call, and so after each later call."""
    cfg = cfg.replace(dtype="float64")
    hop = hop_of(cfg, feature)
    x = np.random.default_rng(3).normal(0, 0.1, 30 * hop)
    psess = port_session(cfg, feature)
    with graphs.disabled():
        esess = port_session(cfg, feature)

    def carry(s):
        return (s._carry,) if path == "stft" else (s._inc.pending, s._inc.pending_e)

    for a, b in ((0, 5 * hop), (5 * hop, 10 * hop), (10 * hop, 30 * hop)):
        psess.process(x[a:b])
        with graphs.disabled():
            esess.process(x[a:b])
        for u, v in zip(carry(psess), carry(esess)):
            assert torch.equal(u, v), (name, a, b)
    assert graph_cache(psess).captures >= 2 and graph_cache(psess).replays >= 1


@pytest.mark.parametrize("name,cfg,feature,path",
                         [SESSIONS[i] for i in (0, 2, 5)], ids=[SESSIONS[i][0] for i in (0, 2, 5)])
def test_reset_mid_stream_zeroes_the_state_in_place(replayed, name, cfg, feature, path):
    """After ``reset()`` mid-stream the same chunks give the same rows: the
    replays read the state at the addresses they captured, so ``reset``
    zeroes it there.  A session whose state is rebound raises."""
    cfg = cfg.replace(dtype="float64")
    chunks = chunks_of(4, cfg, feature, "float64", seconds=2.0)
    sess = port_session(cfg, feature)

    def state(s):
        if path == "stft":
            return (s._carry,)
        return (s._inc.pending, s._inc.pending_e) if path == "carried" else ()

    held = state(sess)
    first = feed(sess, chunks)
    feed(sess, chunks[:3])  # mid-stream
    sess.reset()
    assert all(a is b for a, b in zip(state(sess), held))
    assert all(not t.any() for t in held)
    for a, b in zip(feed(sess, chunks), first):
        assert all(torch.equal(u, v) for u, v in zip(leaves(a), leaves(b))), name
    if held:  # a rebound carry: a replay would read the old tensor
        if path == "stft":
            sess._carry = torch.zeros_like(sess._carry)
        else:
            sess._inc.pending = torch.zeros_like(sess._inc.pending)
        with pytest.raises(RuntimeError, match="rebound"):
            feed(sess, chunks)


def test_interleaved_sessions_keep_their_own_carry(replayed):
    """Two S1 sessions fed two signals call by call: each equals its own
    run alone, and each has its own graphs."""
    cfg = P.speechpy_config(16000, dtype="float64")
    rng = np.random.default_rng(5)
    xs = [rng.normal(0, 0.1, 32000) for _ in range(2)]
    sizes = rng.integers(1, 4001, 20)
    ends = np.cumsum(sizes)
    cut = lambda x: [x[e - n:e] for n, e in zip(sizes, ends) if e <= x.size]
    alone = []
    for x in xs:
        s = StreamingFeatures(cfg, device="cpu")
        alone.append(torch.cat(feed(s, cut(x))))
    a, b = StreamingFeatures(cfg, device="cpu"), StreamingFeatures(cfg, device="cpu")
    assert a._inc._graphs is not b._inc._graphs
    outs = ([], [])
    for ca, cb in zip(cut(xs[0]), cut(xs[1])):
        outs[0].append(a.process(ca))
        outs[1].append(b.process(cb))
    for o, ref in zip(outs, alone):
        assert torch.equal(torch.cat(o), ref)
    assert not torch.equal(alone[0], alone[1])


def test_sessions_on_the_cpu_capture_nothing():
    cfg = P.speechpy_config(16000)
    x = np.random.default_rng(6).normal(0, 0.1, 8000).astype(np.float32)
    sessions = [StreamingFeatures(cfg, device="cpu"),
                StreamingFeatures(cfg.replace(frame_length=0.025), device="cpu"),
                StreamingExtractor(P.vorbis_config(16000), device="cpu")]
    for s in sessions:
        s.process(x[:6400])
        s.process(x[:3200])
    assert all(graph_cache(s).captures == 0 == len(graph_cache(s)) for s in sessions)


@pytest.mark.parametrize("feature", ["mfe", "mfcc"])
def test_float32_carried_energy_at_8k_matches_float64(replayed, feature):
    """At 8 kHz (hop 80) the JAX package's float32 carried step gets the
    carried energy sums wrong after a one-chunk step on the CPU (up to 17%
    of the frame energy against its own float64 session); the port's
    float32 session, replayed, stays within the reference's float32 gate of
    the float64 oracle under the same ragged schedule."""
    from tests.golden import speechpy_ref

    cfg = P.speechpy_config(8000)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 0.1, 24000)
    cuts = np.cumsum([0, *rng.integers(1, 3000, 20)])
    cuts = cuts[cuts <= x.size]
    sess = StreamingFeatures(cfg, feature=feature, device="cpu")
    outs = [sess.process(x[a:b].astype(np.float32)) for a, b in zip(cuts[:-1], cuts[1:])]
    assert graph_cache(sess).replays > 0
    got = tuple(torch.cat(p) for p in zip(*outs)) if feature == "mfe" else (torch.cat(outs),)
    ref = getattr(speechpy_ref, feature)(x[:cuts[-1]], 8000)
    for g, r in zip(got, ref if feature == "mfe" else (ref,)):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() / np.abs(r).max() <= F32_REL
