"""The port's corpus steps through their compiled calls, on the CPU.

On CUDA the steps of ``mfcc_rust_tpu_torch.parallel.data`` (the packed
step with and without packed outputs, the padded step of one head or
several, the unpack-and-resample pass) replay one CUDA graph per (step,
config, feature, mesh, batch, bucket, dtypes) from ``data.steps``: the
counterparts of the JAX package's jitted steps.  Here the ``replayed``
fixture puts ``tests/test_torch_port_graphs.py``'s ``FakeCache`` (a
"replay" recomputes the captured function into its static outputs) in
``data.steps`` and evaluates the eager rule as for a CUDA device, so the
real layer runs: the keys, the capacity-sized static inputs and their
fills, the device-built packed-row index, the trim of the packed outputs.

Tolerances: a replayed step equals the same step run eagerly bitwise (both
run the same ops on the same values; only the static flat buffer is longer
than the batch's, and :func:`_unpack_local` masks every sample past a
row's length).  Against the JAX package, ``tests/test_torch_port_parallel.py``'s
tolerances for the eager step: max|Δ|/max|ref| <= 1e-4 for the log heads
(mfcc, lmfe) and 1e-5 for the others in float32; moments at rtol 1e-5,
atol 1e-6, counts exact."""

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import mfcc_rust_tpu as m
from mfcc_rust_tpu.parallel import data as jdata
from mfcc_rust_tpu.parallel.mesh import make_mesh as jmake_mesh

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.parallel import data as pdata
from mfcc_rust_tpu_torch.parallel import make_mesh
from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
from mfcc_rust_tpu_torch.runtime import write_wav
from mfcc_rust_tpu_torch.utils import graphs
from tests.test_torch_port_graphs import CUDA0, FakeCache

CFG = P.speechpy_config(16000)
JCFG = m.speechpy_config(16000)
HOP = CFG.frame_step
HEADS = ("mfcc", "lmfe", "mfe", "ssc", "energy")


@pytest.fixture
def replayed(monkeypatch):
    """The steps through a :class:`FakeCache` with the eager rule as it
    reads for a CUDA device."""
    cache = FakeCache(maxsize=pdata.STEP_GRAPHS, share_pool=True)
    real = graphs.runs_eagerly
    monkeypatch.setattr(pdata, "steps", cache)
    monkeypatch.setattr(graphs, "runs_eagerly", lambda x, device: real(x, CUDA0))
    return cache


def mesh1():
    return make_mesh(1, 1, device="cpu")


def pcm_clips(seed: int, lengths):
    """Seeded clips on the PCM16 grid (what a WAV decode gives)."""
    rng = np.random.default_rng(seed)
    return [(np.rint(rng.normal(0, 0.1, n) * 32768).clip(-32768, 32767) / 32768)
            .astype(np.float32) for n in lengths]


def batch(seed: int, lengths, b_pad: int, t: int, feature="mfcc"):
    """(flat, offsets, lengths, frame counts) of one packed batch."""
    flat, offs, lens = pdata.pack_signals(pcm_clips(seed, lengths), b_pad)
    assert max(lengths) <= t
    return flat, offs, lens, pdata.frame_counts_host(lens, CFG, feature)


def eager(fn):
    with graphs.disabled():
        return fn()


def leaves(out):
    return pytree.tree_leaves(out)


def assert_same(got, ref):
    g, r = leaves(got), leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.abs(a - ref).max() / np.abs(ref).max()) if ref.size else 0.0


def moments_close(got, want):
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std), rtol=1e-5, atol=1e-6)


T = HOP * 60  # the bucket of the batches below: 9,600 samples, 60 frames


# ------------------------------------------------------------ the keys --
def test_one_capture_per_batch_and_bucket_whatever_the_flat_length(replayed):
    a = batch(1, [9000, 8100, 7000], 4, T)
    b = batch(2, [2000, 9600, 400, 5000], 4, T)
    assert a[0].shape != b[0].shape  # pack_signals' flat lengths differ
    for flat, offs, lens, counts in (a, b, a):
        pdata.extraction_step_packed(flat, offs, lens, T, CFG, mesh1(), frame_counts=counts)
    assert (replayed.captures, replayed.replays, len(replayed)) == (1, 2, 1)
    (full,) = replayed._graphs
    assert full[1] == ((4 * T,), (16,))  # the flat's capacity B * t; 4 header rows of 4
    # another batch size, another bucket, the step without packed outputs:
    # a key each
    c = batch(3, [3000, 4000], 2, T)
    pdata.extraction_step_packed(*c[:3], T, CFG, mesh1(), frame_counts=c[3])
    pdata.extraction_step_packed(*a[:3], T + HOP * 4, CFG, mesh1(), frame_counts=a[3])
    pdata.extraction_step_packed(*a[:3], T, CFG, mesh1())
    assert (replayed.captures, len(replayed)) == (4, 4)


@pytest.mark.parametrize("packed", [True, False], ids=["packed_outputs", "padded_outputs"])
def test_short_flat_in_a_capacity_sized_static_input_gives_eager(replayed, packed):
    """The static flat buffer holds B * t samples and keeps the samples of
    earlier batches past this one's: they are masked, never read."""
    long_ = batch(4, [9600, 9500, 9400, 9300], 4, T)
    short = batch(5, [1000, 300, 0, 2500], 4, T)
    kw = lambda c: {"frame_counts": c} if packed else {}
    pdata.extraction_step_packed(*long_[:3], T, CFG, mesh1(), **kw(long_[3]))
    (g,) = replayed._graphs.values()
    flat_static = g.static[0]
    assert flat_static.shape[0] == 4 * T > short[0].shape[0]
    flat_static[short[0].shape[0]:] = 32767  # whatever an earlier batch left
    got = pdata.extraction_step_packed(*short[:3], T, CFG, mesh1(), **kw(short[3]))
    ref = eager(lambda: pdata.extraction_step_packed(*short[:3], T, CFG, mesh1(), **kw(short[3])))
    assert replayed.replays == 1
    assert_same(got, ref)
    if packed:
        assert got[0].shape == (int(short[3].sum()), 13)


def test_a_clip_longer_than_the_bucket_widens_the_flat_capacity(replayed):
    """A clip past the bucket is cut at t, as the eager step cuts it; the
    static input then holds every sample the step reads."""
    flat, offs, lens = pdata.pack_signals(pcm_clips(6, [T + 5000, T]), 2)
    got = pdata.extraction_step_packed(flat, offs, lens, T, CFG, mesh1())
    ref = eager(lambda: pdata.extraction_step_packed(flat, offs, lens, T, CFG, mesh1()))
    assert_same(got, ref)
    (full,) = replayed._graphs
    assert full[1][0] == (T + 5000 + T,)  # past B * t: the second row ends there


# ------------------------------------------------- the packed-row index --
@pytest.mark.parametrize("seed", range(6))
def test_device_packed_index_equals_repeat_interleave(seed):
    rng = np.random.default_rng(seed)
    bl, f = int(rng.integers(1, 9)), int(rng.integers(1, 40))
    counts = rng.integers(0, f + 1, bl)
    counts[rng.random(bl) < 0.3] = 0  # zero-frame rows anywhere
    if seed == 0:
        counts[:] = 0  # an all-zero batch
    offs, total = pdata._frame_pack_args(counts)
    c, r = torch.from_numpy(counts), torch.from_numpy(offs)
    row, fr, has = pdata._packed_index(c, r, bl * f)
    want_row = torch.repeat_interleave(torch.arange(bl), c, output_size=total)
    want_fr = torch.arange(total) - r[want_row]
    assert torch.equal(row[:total], want_row) and torch.equal(fr[:total], want_fr)
    assert has[:total].all() and not has[total:].any()


# ------------------------------------------ replayed steps against JAX --
@pytest.mark.parametrize("feature", ["mfcc", ("mfcc", "mfe", "energy")], ids=["mfcc", "multi"])
def test_trimmed_packed_outputs_equal_the_jax_step(replayed, feature):
    """Two batches of one bucket through one graph: each trimmed output
    holds exactly the valid frames, equal to the JAX step's first n rows
    (its buffer is those, then a zero tail)."""
    jm = jmake_mesh(n_data=1, n_seq=1, devices=jax.devices()[:1])
    key = feature if isinstance(feature, str) else tuple(feature)
    for seed, lengths in ((7, [9600, 7000, 400, 8888]), (8, [5000, 9000, 2500, 0])):
        flat, offs, lens, counts = batch(seed, lengths, 4, T)
        pk, mom = pdata.extraction_step_packed(flat, offs, lens, T, CFG, mesh1(), key,
                                               frame_counts=counts)
        jpk, jmom = jdata.extraction_step_packed(flat, offs, lens, T, JCFG, jm, key,
                                                 frame_counts=counts)
        n = int(counts.sum())
        heads = [key] if isinstance(key, str) else list(key)
        for h in heads:
            got = pk if isinstance(key, str) else pk[h]
            ref = jpk if isinstance(key, str) else jpk[h]
            if h == "mfe":
                got, ref = got[0], ref[0]
            ref = np.asarray(ref)
            assert got.shape[0] == n and not ref[n:].any()
            assert rel(got, ref[:n]) <= (1e-4 if h in ("mfcc", "lmfe") else 1e-5), h
            moments_close(mom if isinstance(key, str) else mom[h],
                          jmom if isinstance(key, str) else jmom[h])
    assert (replayed.captures, replayed.replays) == (1, 1)


def test_unpack_resample_replays_equal_eager_and_jax(replayed):
    clips = pcm_clips(9, [4000, 8000, 100])
    flat, offs, lens = pdata.pack_signals(clips, 4)
    t_src = 8000
    got = [pdata.unpack_resample(flat, offs, lens, t_src, 2, 1, mesh1()) for _ in range(2)]
    ref = eager(lambda: pdata.unpack_resample(flat, offs, lens, t_src, 2, 1, mesh1()))
    assert (replayed.captures, replayed.replays) == (1, 1)
    for g in got:
        assert_same(g, ref)
    jref = np.asarray(jdata.unpack_resample(flat, offs, lens, t_src, 2, 1,
                                            jmake_mesh(n_data=1, n_seq=1,
                                                       devices=jax.devices()[:1])))
    np.testing.assert_allclose(got[0].numpy(), jref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wire", [None, "float16"], ids=["f32", "f16_wire"])
def test_five_head_padded_step_replays_equal_eager(replayed, wire):
    """The resample path's step: the five speechpy heads of a device block
    with packed outputs, replayed equal to eager."""
    clips = pcm_clips(10, [9600, 6000, 3000, 0])
    sig = np.zeros((4, T), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    lens = np.array([len(c) for c in clips])
    counts = pdata.frame_counts_host(lens, CFG, "mfcc")
    step = lambda x: pdata.extraction_step(x, lens, CFG, mesh1(), HEADS, frame_counts=counts,
                                           wire_dtype=wire)
    x = torch.from_numpy(sig)
    got = [step(x), step(x * 0.5)]
    ref = eager(lambda: (step(x), step(x * 0.5)))
    assert (replayed.captures, replayed.replays) == (1, 1)
    for g, r in zip(got, ref):
        assert_same(g, r)
        assert g[0]["mfcc"].shape == (int(counts.sum()), 13)


def test_padded_step_without_packed_outputs_replays_equal_eager(replayed):
    clips = pcm_clips(11, [9600, 5000])
    sig = np.zeros((2, T), np.float32)
    for i, c in enumerate(clips):
        sig[i, :len(c)] = c
    lens = [len(c) for c in clips]
    got = [pdata.extraction_step(sig, lens, CFG, mesh1(), f) for f in ("mfcc", HEADS, "mfcc")]
    ref = eager(lambda: [pdata.extraction_step(sig, lens, CFG, mesh1(), f)
                         for f in ("mfcc", HEADS, "mfcc")])
    assert (replayed.captures, replayed.replays) == (2, 1)
    assert_same(got, ref)


def test_a_failed_capture_raises_and_nothing_runs_eagerly(replayed, monkeypatch):
    def broken(fn, static, state=()):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(replayed, "_record", broken)
    flat, offs, lens, counts = batch(12, [9000, 100], 2, T)
    with pytest.raises(RuntimeError, match="capture failed"):
        pdata.extraction_step_packed(flat, offs, lens, T, CFG, mesh1(), frame_counts=counts)
    assert len(replayed) == 0


# ----------------------------------------------------------- the runner --
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """20 WAV files in three length buckets at 16 kHz and four at 22.05 kHz."""
    d = tmp_path_factory.mktemp("graph_corpus")
    rng = np.random.default_rng(13)
    paths = []
    for i in range(24):
        sr = 22050 if i >= 20 else 16000
        n = int((0.6 + (i % 3) * 0.5 + rng.uniform(0, 0.1)) * sr)
        write_wav(str(d / f"u{i:02d}.wav"), rng.normal(0, 0.1, n).astype(np.float32), sr)
        paths.append(str(d / f"u{i:02d}.wav"))
    return paths


def run_corpus(paths, out, **kw):
    r = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out), **kw)
    return r.run(), r


@pytest.mark.parametrize("kw", [{}, {"feature": HEADS, "wire_dtype": "float16"},
                                {"resample": True}], ids=["mfcc", "five_heads", "resample"])
def test_replayed_runner_equals_the_eager_runner(corpus, tmp_path, replayed, kw):
    paths = corpus if kw.get("resample") else corpus[:20]
    mom, r = run_corpus(paths, tmp_path / "g", **kw)
    ref_mom, _ = eager(lambda: run_corpus(paths, tmp_path / "e", **kw))
    assert replayed.captures == len(replayed) < r.meter.counters["dispatches"]
    assert replayed.replays > 0
    for a, b in zip(pytree.tree_leaves(mom), pytree.tree_leaves(ref_mom)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for p in sorted((tmp_path / "e").iterdir()):
        a, b = np.load(p), np.load(tmp_path / "g" / p.name)
        for k in (a.files if hasattr(a, "files") else [None]):
            np.testing.assert_array_equal(a if k is None else a[k], b if k is None else b[k])


def test_a_cpu_runner_captures_nothing(corpus, tmp_path, monkeypatch):
    cache = FakeCache(maxsize=pdata.STEP_GRAPHS, share_pool=True)
    monkeypatch.setattr(pdata, "steps", cache)
    run_corpus(corpus, tmp_path / "cpu", resample=True)
    assert (cache.captures, cache.replays, len(cache)) == (0, 0, 0)
    assert len(list((tmp_path / "cpu").iterdir())) == len(corpus)
