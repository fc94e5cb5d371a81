"""The port's corpus runner (``mfcc_rust_tpu_torch.parallel.runner``) on CPU
meshes: the cases of tests/test_runner.py (all but the v5e speed-of-light
model, which is not ported, and the CLI), on one-rank meshes; then the
runner on a gloo world of four at (2, 2) where rank 0 alone writes; the
two-process multi-host case of tests/test_multihost.py; and a checkpoint
written by the JAX runner finished by the port's.

Tolerances: outputs against the float64 speechpy oracle at the reference's
3e-3 gate; moments against numpy over the written files at rtol 1e-4,
atol 1e-5 (the reference test's); runs that differ only in scheduling
bitwise; the port against the JAX runner (and against its own one-rank
run) at rtol 1e-5, atol 1e-6 for the mean and std, counts exact."""

import dataclasses
import json
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu.parallel import make_mesh as jmake_mesh
from mfcc_rust_tpu.parallel.runner import CorpusRunner as JRunner
from tests.golden import speechpy_ref as sp
from tests.test_torch_port_parallel import run_world

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.ops.resample import resample_poly
from mfcc_rust_tpu_torch.parallel import make_mesh
from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner, merge_checkpoints
from mfcc_rust_tpu_torch.runtime import read_wav, write_wav

CFG = P.speechpy_config(16000)
JCFG = m.speechpy_config(16000)


def mesh1():
    return make_mesh(1, 1, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_corpus")
    rng = np.random.default_rng(20)
    paths, clips = [], []
    for i in range(10):
        n = 8000 + 640 * i
        clip = rng.normal(0, 0.1, n).astype(np.float32).clip(-1, 1)
        p = d / f"utt{i:02d}.wav"
        write_wav(str(p), clip, 16000)
        paths.append(str(p))
        clips.append(clip)
    return paths, clips


def moments_match(a, b):
    assert int(a.count) == int(b.count)
    np.testing.assert_allclose(np.asarray(a.mean), np.asarray(b.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.std), np.asarray(b.std), rtol=1e-5, atol=1e-6)


def test_runner_end_to_end(corpus, tmp_path):
    paths, clips = corpus
    out = tmp_path / "feats"
    runner = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out))
    moments = runner.run()
    all_feats = []
    for i, p in enumerate(paths):
        f = np.load(out / f"utt{i:02d}.npy")
        dec, _ = read_wav(p)
        gold = sp.mfcc(dec.astype(np.float64), 16000)
        assert f.shape == gold.shape
        np.testing.assert_allclose(f, gold, rtol=3e-3, atol=3e-3)
        all_feats.append(f)
    allv = np.concatenate(all_feats)
    np.testing.assert_allclose(np.asarray(moments.mean), allv.mean(0), rtol=1e-4, atol=1e-5)
    assert int(moments.count) == allv.shape[0]
    assert runner.meter.audio_seconds > 0 and runner.meter.throughput > 0
    # the JAX runner on the same corpus
    moments_match(moments, JRunner(paths, JCFG, jmake_mesh(1, 1, devices=jax.devices()[:1]),
                                   batch_size=4).run())


def test_runner_checkpoint_resume(corpus, tmp_path):
    paths, _ = corpus
    ck = tmp_path / "state.npz"
    out = tmp_path / "feats"

    class Stop(Exception):
        pass

    calls = []

    def boom(info):
        calls.append(info)
        if len(calls) == 1:
            raise Stop()

    r1 = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out),
                      checkpoint_path=str(ck), checkpoint_every=1, on_batch=boom)
    with pytest.raises(Stop):
        r1.run()
    assert ck.exists()
    r2 = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out),
                      checkpoint_path=str(ck), checkpoint_every=1)
    assert int(np.load(ck, allow_pickle=False)["done"].sum()) >= 4
    moments = r2.run()
    ref = CorpusRunner(paths, CFG, mesh1(), batch_size=4).run()
    np.testing.assert_allclose(np.asarray(moments.total), np.asarray(ref.total), rtol=1e-5,
                               atol=1e-4)
    assert int(moments.count) == int(ref.count)


def test_runner_multihost_simulation(corpus, tmp_path):
    """Two runners, each over its slice on its own mesh; the merged
    checkpoint moments == one runner over the corpus."""
    paths, _ = corpus
    cks = []
    for host in range(2):
        ck = tmp_path / f"host{host}.npz"
        CorpusRunner(paths, CFG, mesh1(), batch_size=4, checkpoint_path=str(ck),
                     process_index=host, process_count=2).run()
        cks.append(str(ck))
    merged = merge_checkpoints(cks, CFG.num_cepstral)
    single = CorpusRunner(paths, CFG, mesh1(), batch_size=4).run()
    np.testing.assert_allclose(np.asarray(merged.total), np.asarray(single.total), rtol=1e-5,
                               atol=1e-4)
    assert int(merged.count) == int(single.count)


def test_runner_fetch_depth_invariance(corpus, tmp_path):
    """Dispatch-ahead depth and fetch threads are latency knobs: bitwise
    identical outputs and moments (the loader emits in path order)."""
    paths, _ = corpus
    runs = {}
    for depth, threads in ((1, 0), (3, 2), (64, 1)):
        out = tmp_path / f"feats_d{depth}"
        moments = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out),
                               fetch_every=depth, fetch_threads=threads).run()
        runs[depth] = (out, moments)
    out1, m1 = runs[1]
    for depth in (3, 64):
        outd, md = runs[depth]
        assert np.array_equal(np.asarray(m1.mean), np.asarray(md.mean))
        assert np.array_equal(np.asarray(m1.m2), np.asarray(md.m2))
        assert int(m1.count) == int(md.count)
        for f in sorted(out1.glob("*.npy")):
            assert np.array_equal(np.load(f), np.load(outd / f.name)), f.name


def test_runner_bitwise_deterministic(corpus, tmp_path):
    paths, _ = corpus
    results = []
    for run in range(2):
        out = tmp_path / f"det{run}"
        moments = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out),
                               n_io_threads=8, fetch_threads=2).run()
        results.append((out, moments))
    (out0, m0), (out1, m1) = results
    assert np.array_equal(np.asarray(m0.mean), np.asarray(m1.mean))
    assert np.array_equal(np.asarray(m0.m2), np.asarray(m1.m2))
    assert int(m0.count) == int(m1.count)
    for f in sorted(out0.glob("*.npy")):
        assert np.array_equal(np.load(f), np.load(out1 / f.name)), f.name


def test_runner_packed_output_matches_padded(corpus, tmp_path):
    """Packed outputs (valid frames only) write the same files and moments
    as the padded layout: the epilogue only gathers."""
    paths, _ = corpus
    out_a, out_b = tmp_path / "packed", tmp_path / "padded"
    mom_a = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_a),
                         packed_output=True).run()
    mom_b = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_b),
                         packed_output=False).run()
    for p in sorted(out_b.iterdir()):
        np.testing.assert_array_equal(np.load(out_a / p.name), np.load(p))
    np.testing.assert_array_equal(np.asarray(mom_a.mean), np.asarray(mom_b.mean))
    np.testing.assert_array_equal(np.asarray(mom_a.m2), np.asarray(mom_b.m2))
    assert int(mom_a.count) == int(mom_b.count)


def test_runner_wire_f16_outputs(corpus, tmp_path):
    """float16 wire: the outputs are the f32 run's cast to float16; moments
    stay f32 and identical; bfloat16 outputs are written as the float32 of
    the bfloat16 values."""
    paths, _ = corpus
    out_a, out_b, out_c = tmp_path / "f16", tmp_path / "f32", tmp_path / "bf16"
    mom_a = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_a),
                         wire_dtype="float16").run()
    mom_b = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_b)).run()
    CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_c),
                 wire_dtype="bfloat16").run()
    for p in sorted(out_b.iterdir()):
        a, b = np.load(out_a / p.name), np.load(p)
        assert a.dtype == np.float16
        np.testing.assert_array_equal(a, b.astype(np.float16))
        c = np.load(out_c / p.name)
        ref = torch.from_numpy(b).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(c, ref)
    np.testing.assert_array_equal(np.asarray(mom_a.mean), np.asarray(mom_b.mean))
    assert np.asarray(mom_a.mean).dtype == np.float32
    with pytest.raises(ValueError, match="wire_dtype"):
        CorpusRunner(paths, CFG, mesh1(), packed_output=False, wire_dtype="float16")


def test_runner_wire_pooling_outputs_match(corpus, tmp_path):
    """pool_growth (coarse length bands): identical per-utterance outputs;
    moments agree to merge-order tolerance."""
    paths, _ = corpus
    out_a, out_b = tmp_path / "bucketed", tmp_path / "pooled"
    mom_a = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_a)).run()
    mom_b = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(out_b),
                         pool_growth=2.5).run()
    for p in sorted(out_a.iterdir()):
        np.testing.assert_array_equal(np.load(p), np.load(out_b / p.name))
    np.testing.assert_allclose(np.asarray(mom_a.mean), np.asarray(mom_b.mean), rtol=1e-5,
                               atol=1e-6)
    assert int(mom_a.count) == int(mom_b.count)


def test_runner_rejects_wrong_sample_rate(tmp_path):
    p = tmp_path / "bad_sr.wav"
    write_wav(str(p), np.random.default_rng(21).normal(0, 0.1, 8000).astype(np.float32), 8000)
    runner = CorpusRunner([str(p)], CFG, mesh1(), batch_size=1)
    with pytest.raises(ValueError, match="sample rate"):
        runner.run()


def test_runner_mixed_rates_resample(tmp_path):
    """A mixed 8k/16k/22.05k corpus with resample=True: every file's
    features match the oracle on the decoded, resampled samples."""
    rng = np.random.default_rng(22)
    d = tmp_path / "mixed"
    d.mkdir()
    paths, rates = [], []
    for i, sr in enumerate([16000, 8000, 8000, 16000, 22050]):
        clip = rng.normal(0, 0.1, sr + 321 * i).astype(np.float32).clip(-1, 1)
        p = d / f"mix{i}.wav"
        write_wav(str(p), clip, sr)
        paths.append(str(p))
        rates.append(sr)
    out = tmp_path / "mixed_feats"
    moments = CorpusRunner(paths, CFG, mesh1(), batch_size=2, out_dir=str(out),
                           resample=True).run()
    assert int(moments.count) > 0
    for i, (p, sr) in enumerate(zip(paths, rates)):
        dec, _ = read_wav(p)
        dec = dec.astype(np.float64)
        if sr != 16000:
            g = math.gcd(16000, sr)
            dec = resample_poly(torch.from_numpy(dec), 16000 // g, sr // g).numpy()
        gold = sp.mfcc(dec, 16000)
        f = np.load(out / f"mix{i}.npy")
        assert f.shape == gold.shape
        np.testing.assert_allclose(f, gold, rtol=3e-3, atol=3e-3)


def test_runner_rate_mismatch_raises(tmp_path):
    clip = np.random.default_rng(23).normal(0, 0.1, 8000).astype(np.float32).clip(-1, 1)
    p = tmp_path / "wrong.wav"
    write_wav(str(p), clip, 8000)
    runner = CorpusRunner([str(p)], CFG, mesh1(), batch_size=1, out_dir=str(tmp_path / "o"))
    with pytest.raises(ValueError, match="sample rate"):
        runner.run()


def test_runner_multi_feature(corpus, tmp_path):
    """Tuple feature: .npz outputs match the single-feature run, moments and
    checkpoint resume are per feature."""
    paths, _ = corpus
    out = tmp_path / "multi"
    ckpt = tmp_path / "ckpt.npz"
    which = ("mfcc", "lmfe", "energy")
    moments = CorpusRunner(paths, CFG, mesh1(), feature=which, batch_size=4, out_dir=str(out),
                           checkpoint_path=str(ckpt)).run()
    assert sorted(moments) == sorted(which)
    single_out = tmp_path / "single"
    smoments = CorpusRunner(paths, CFG, mesh1(), feature="mfcc", batch_size=4,
                            out_dir=str(single_out)).run()
    for p in paths:
        stem = pathlib.Path(p).stem
        z = np.load(out / f"{stem}.npz")
        assert sorted(z.files) == sorted(which)
        ref = np.load(single_out / f"{stem}.npy")
        np.testing.assert_allclose(z["mfcc"], ref, rtol=1e-6, atol=1e-6)
        assert z["lmfe"].shape == (ref.shape[0], CFG.num_filters)
        assert z["energy"].shape == (ref.shape[0],)
    np.testing.assert_allclose(np.asarray(moments["mfcc"].total), np.asarray(smoments.total),
                               rtol=3e-5)
    assert int(moments["energy"].count) == int(smoments.count)
    m2 = CorpusRunner(paths, CFG, mesh1(), feature=which, batch_size=4, out_dir=str(out),
                      checkpoint_path=str(ckpt)).run()
    np.testing.assert_allclose(np.asarray(m2["mfcc"].total), np.asarray(moments["mfcc"].total))
    merged = merge_checkpoints([str(ckpt)], None, features=which)
    np.testing.assert_allclose(np.asarray(merged["lmfe"].total),
                               np.asarray(moments["lmfe"].total))


# -------------------------------------------------- multi-rank and cross --
def test_runner_spmd_gloo_world4(corpus, tmp_path):
    """One runner over a (2, 2) mesh of four gloo ranks: rank 0 alone
    consumes and writes; every file written once; every rank returns the
    same moments, those of the one-rank runner."""
    paths, _ = corpus
    (tmp_path / "paths.json").write_text(json.dumps(paths))
    run_world("runner", tmp_path, 4, (2, 2, tmp_path / "paths.json"))
    ranks = [np.load(tmp_path / f"runner.rank{r}.npz") for r in range(4)]
    assert [int(z["batches"]) > 0 for z in ranks] == [True, False, False, False]
    assert [tuple(z["coords"]) for z in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for z in ranks[1:]:
        for k in ("count", "mean", "m2"):
            assert np.array_equal(z[k], ranks[0][k])
    written = sorted(f.name for f in (tmp_path / "out").iterdir())
    assert written == [f"utt{i:02d}.npy" for i in range(10)]
    one_dir = tmp_path / "one"
    one = CorpusRunner(paths, CFG, mesh1(), batch_size=4, out_dir=str(one_dir)).run()
    got = P.parallel.CorpusMoments(ranks[0]["count"], ranks[0]["mean"], ranks[0]["m2"])
    moments_match(got, one)
    for name in written:
        np.testing.assert_allclose(np.load(tmp_path / "out" / name), np.load(one_dir / name),
                                   rtol=1e-4, atol=1e-4)
    assert np.load(tmp_path / "ck.npz")["done"].all()


def test_two_process_distributed_corpus(tmp_path):
    """Two processes, one runner each over its slice (process_count=2) on
    its own one-rank mesh; a mesh spanning both runners is refused; every
    utterance written once; the merged checkpoints == one runner."""
    rng = np.random.default_rng(24)
    paths = []
    for i in range(8):
        clip = rng.normal(0, 0.1, 8000 + 777 * i).astype(np.float32).clip(-1, 1)
        p = tmp_path / f"utt{i:02d}.wav"
        write_wav(str(p), clip, 16000)
        paths.append(str(p))
    (tmp_path / "paths.json").write_text(json.dumps(paths))
    run_world("host", tmp_path, 2, (tmp_path / "paths.json",))
    written = sorted(f.name for f in (tmp_path / "out").glob("*.npy"))
    assert written == [f"utt{i:02d}.npy" for i in range(8)]
    merged = merge_checkpoints([str(tmp_path / "host0.npz"), str(tmp_path / "host1.npz")],
                               CFG.num_cepstral)
    single = CorpusRunner(paths, CFG, mesh1(), batch_size=2).run()
    assert int(merged.count) == int(single.count)
    np.testing.assert_allclose(np.asarray(merged.mean), np.asarray(single.mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(merged.m2), np.asarray(single.m2), rtol=1e-4,
                               atol=1e-4)


def test_port_finishes_a_jax_checkpoint(corpus, tmp_path):
    """The JAX runner, stopped after its first batch, is finished by the
    port's runner from the JAX checkpoint: the moments equal the JAX
    uninterrupted run's, and every file is written."""
    paths, _ = corpus
    ck, out = tmp_path / "state.npz", tmp_path / "feats"
    jmesh = jmake_mesh(n_data=4, n_seq=1, devices=jax.devices()[:4])

    class Stop(Exception):
        pass

    def boom(info):
        raise Stop()

    with pytest.raises(Stop):
        JRunner(paths, JCFG, jmesh, batch_size=4, out_dir=str(out), checkpoint_path=str(ck),
                checkpoint_every=1, on_batch=boom).run()
    done = np.load(ck, allow_pickle=False)["done"]
    assert 0 < int(done.sum()) < len(paths)
    pcfg = P.from_reference(dataclasses.asdict(JCFG))
    moments = CorpusRunner(paths, pcfg, mesh1(), batch_size=4, out_dir=str(out),
                           checkpoint_path=str(ck), checkpoint_every=1).run()
    ref = JRunner(paths, JCFG, jmesh, batch_size=4).run()
    moments_match(moments, ref)
    assert np.load(ck, allow_pickle=False)["done"].all()
    assert sorted(f.name for f in out.glob("*.npy")) == [f"utt{i:02d}.npy" for i in range(10)]
