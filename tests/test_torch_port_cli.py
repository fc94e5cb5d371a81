"""The port's command line (``mfcc_rust_tpu_torch.cli``, ``python -m
mfcc_rust_tpu_torch``) against the JAX package's (``mfcc_rust_tpu.cli``) on
the same WAV files, on the CPU (``--device cpu``).

Both write the same output names and npz keys and report the same
``utterances`` and ``corpus_frames``; the port's arrays are within rtol
1e-4, atol 1e-4 of the JAX package's (the tolerance of the port's runner
tests across meshes; two float32 programs of the chunk-GEMM), its CMVN
moments within rtol 1e-5, atol 1e-6 (the runner tests' moments tolerance,
counts exact), a standard deviation also within 2^-20 of its column's
|mean|: a column that is constant but for float32 rounding (the lowest SSC
bands weigh one bin each) has a standard deviation of a few ulps of its
mean, which two programs round differently.  Both refuse the same command
lines with exit code 2.  A gloo world of four processes, two hosts of two
ranks, writes what the one-process run writes."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mfcc_rust_tpu import cli as jcli
from tests.test_torch_port_parallel import run_world

from mfcc_rust_tpu_torch import cli as pcli
from mfcc_rust_tpu_torch.parallel import stats as pstats
from mfcc_rust_tpu_torch.runtime import write_wav

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The clips of tests/test_runner.py's ``corpus`` fixture: ten WAVs of
    8000 + 640 i samples at 16 kHz, N(0, 0.1) clipped to ±1."""
    d = tmp_path_factory.mktemp("cli_corpus")
    rng = np.random.default_rng(12345)
    paths = []
    for i in range(10):
        clip = rng.normal(0, 0.1, 8000 + 640 * i).astype(np.float32).clip(-1, 1)
        p = d / f"utt{i:02d}.wav"
        write_wav(str(p), clip, 16000)
        paths.append(str(p))
    return paths


def _run(main, paths, out: Path, feature: str, capsys, *extra):
    rc = main([*paths, "--feature", feature, "--out-dir", str(out),
               "--cmvn-out", str(out) + ".cmvn.npz", "--batch-size", "4", "--quiet", *extra])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, report, np.load(str(out) + ".cmvn.npz")


def _close(got, ref, tol):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **tol)


OUT_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("feature", ["mfcc", "mfcc,ssc"])
def test_cli_matches_jax_cli(corpus, tmp_path, capsys, feature):
    prc, prep, pz = _run(pcli.main, corpus, tmp_path / "port", feature, capsys, "--device", "cpu")
    jrc, jrep, jz = _run(jcli.main, corpus, tmp_path / "jax", feature, capsys)
    assert prc == jrc == 0
    names = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert len(names) == len(corpus)
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert sorted(a.files) == sorted(b.files) == sorted(feature.split(","))
            for k in a.files:
                _close(a[k], b[k], OUT_TOL)
        else:
            _close(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name), OUT_TOL)
    assert sorted(pz.files) == sorted(jz.files)
    for k in pz.files:
        if k.startswith("count"):
            assert int(pz[k]) == int(jz[k]), k
        elif k.startswith("std"):
            atol = 1e-6 + 2.0 ** -20 * np.abs(jz["mean" + k[3:]])
            assert (np.abs(pz[k] - jz[k]) <= atol + 1e-5 * np.abs(jz[k])).all(), k
        elif not k.startswith("m2"):
            _close(pz[k], jz[k], MOMENT_TOL)
    for key in ("utterances", "corpus_frames"):
        assert prep[key] == jrep[key], key
    assert prep["utterances"] == len(corpus)
    assert set(prep) == set(jrep)


REFUSED = [
    ("no input", lambda d: [str(d / "none*.wav")]),
    ("unknown feature", lambda d: ["--feature", "plp"]),
    ("melspec in a list", lambda d: ["--feature", "mfcc,melspec"]),
    ("unknown entry in a list", lambda d: ["--feature", "mfcc,pitch"]),
]


@pytest.mark.parametrize("name,args", REFUSED, ids=[r[0] for r in REFUSED])
def test_cli_exit_code_2(corpus, tmp_path, name, args):
    extra = args(tmp_path)
    inputs = [] if name == "no input" else corpus[:1]
    for main, dev in ((pcli.main, ["--device", "cpu"]), (jcli.main, [])):
        assert main([*inputs, *extra, "--out-dir", str(tmp_path / "o"), *dev]) == 2, name


def test_python_m_runs_the_cli(corpus, tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "mfcc_rust_tpu_torch", *corpus[:3], "--out-dir",
         str(tmp_path / "o"), "--device", "cpu", "--quiet"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["utterances"] == 3 and report["corpus_frames"] > 0
    assert sorted(f.name for f in (tmp_path / "o").iterdir()) == \
        [Path(p).stem + ".npy" for p in corpus[:3]]


def test_cli_two_hosts_of_two_ranks_equal_one_process(corpus, tmp_path, capsys):
    """Four gloo processes as a torchrun world of two hosts
    (``LOCAL_WORLD_SIZE=2``): each host takes every other file on its own
    two-rank mesh, its rank 0 writes its outputs and moments and prints
    the report, its rank 1 prints nothing."""
    (tmp_path / "paths.json").write_text(json.dumps(corpus))
    run_world("cli", tmp_path, 4, (2, tmp_path / "paths.json"))
    ranks = [json.loads((tmp_path / f"cli.rank{r}.json").read_text()) for r in range(4)]
    assert [r["rc"] for r in ranks] == [0, 0, 0, 0]
    assert [bool(r["stdout"].strip()) for r in ranks] == [True, False, True, False]
    reports = [json.loads(ranks[r]["stdout"].strip().splitlines()[-1]) for r in (0, 2)]
    assert [r["utterances"] for r in reports] == [5, 5]

    rc, one, oz = _run(pcli.main, corpus, tmp_path / "one", "mfcc", capsys, "--device", "cpu")
    assert rc == 0
    names = sorted(f.name for f in (tmp_path / "out").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "one").iterdir())
    for name in names:
        _close(np.load(tmp_path / "out" / name), np.load(tmp_path / "one" / name), OUT_TOL)
    assert sum(r["corpus_frames"] for r in reports) == one["corpus_frames"]
    hosts = [np.load(tmp_path / f"cmvn.host{h}.npz") for h in (0, 1)]
    merged = pstats.tree_merge([pstats.CorpusMoments(z["count"], z["mean"], z["m2"])
                                for z in hosts])
    assert int(merged.count) == int(oz["count"])
    _close(np.asarray(merged.mean), oz["mean"], MOMENT_TOL)
    _close(np.asarray(merged.std), oz["std"], MOMENT_TOL)
