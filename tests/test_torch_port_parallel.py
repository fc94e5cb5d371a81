"""The port's data-parallel step (``mfcc_rust_tpu_torch.parallel``) on
multi-rank CPU meshes under gloo, held against the JAX package on a mesh of
the same layout: the cases of tests/test_parallel.py (all but the graft
entry), at (n_data, n_seq) = (2, 2), (4, 1) and (1, 4).

For each layout one module-scoped fixture starts ONE gloo group of four
processes (``tests/test_torch_port_dist_worker.py``, FileStore in a
temporary directory, 60 s on every collective).  They run every case and
save each rank's blocks and rank 0's gathered outputs; the processes are
joined with a 180 s limit and killed on expiry, so a hang fails the test.
The parent runs the JAX step on ``make_mesh(n_data, n_seq,
devices=jax.devices()[:4])`` with the same seeded inputs.

Tolerances.  Port against JAX on the valid frames, as max|Δ|/max|ref|
(the port's cross-package measure, tests/test_torch_port_extract.py):
<= 1e-4 for the log quantities (mfcc, lmfe) and 1e-5 for the others in
float32, and <= 1e-9 in float64.  1e-4 is chip_smoke.py's gate of two
float32 forms of one product: the first speechpy filter weighs the DC bin
alone, X_0 = sum(x) nearly cancels on a few random frames, and two float32
programs that round X_0 differently then move that band's log by up to
~5e-4 (max|ref| ~10 here).  Against the oracles and the single-device functions, the
tolerances of tests/test_parallel.py.  Masks and counts exact; corpus
moments (mean, std) at rtol 1e-5, atol 1e-6; every rank's own block equals
its slice of the gathered output bitwise.  The unit cases (moments, merges,
fetch) are bitwise or at the stated tolerance."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

import mfcc_rust_tpu as m
from mfcc_rust_tpu.ops import stft as JS
from mfcc_rust_tpu.parallel import data as jdata
from mfcc_rust_tpu.parallel import halo as jhalo
from mfcc_rust_tpu.parallel import stats as jstats
from mfcc_rust_tpu.parallel.mesh import make_mesh as jmake_mesh
from tests.golden import speechpy_ref as sp
from tests.test_torch_port_dist_worker import CASES, LAYOUTS, config, inputs

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.parallel import data as pdata
from mfcc_rust_tpu_torch.parallel import stats as pstats

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 180


def run_world(task: str, work: Path, world: int, args=()) -> None:
    """Start ``world`` worker processes of ``task`` (one gloo group) and
    wait for them all, failing on a non-zero exit or after JOIN_S."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = []
    for r in range(world):
        log = open(work / f"{task}.rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_port_dist_worker", task, str(r),
             str(world), str(work), *map(str, args)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + JOIN_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{task} workers did not finish in {JOIN_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (work / f"{task}.rank{r}.log").read_text()[-4000:]


@pytest.fixture(scope="module", params=LAYOUTS, ids=[f"{a}x{b}" for a, b in LAYOUTS])
def port(request, tmp_path_factory):
    """(n_data, n_seq, loader of rank r's results for a case)."""
    n_data, n_seq = request.param
    work = tmp_path_factory.mktemp(f"gloo_{n_data}x{n_seq}")
    run_world("parallel", work, 4, (n_data, n_seq))

    def load(case: str, rank: int = 0) -> dict:
        with np.load(work / f"{case}.rank{rank}.npz") as z:
            return {k: z[k] for k in z.files}

    return n_data, n_seq, load


def jmesh(port):
    return jmake_mesh(n_data=port[0], n_seq=port[1], devices=jax.devices()[:4])


def jcfg_of(case):
    kw, _ = inputs(case)
    return config(m, kw)


def check_blocks(port, case: str, tag: str, packed: bool = False):
    """Every rank's own block equals its slice of rank 0's gathered output:
    rows by the data index, time by the seq index (packed rows: the data
    ranks' buffers in order)."""
    n_data, n_seq, load = port
    g = load(case)
    heads = (f"g/{tag}/0",) if packed else (f"g/{tag}/0", f"g/{tag}/1")
    keys = [k for k in g if k.startswith(heads)]
    offs = {}
    for r in range(4):
        d, s = divmod(r, n_seq)
        loc = load(case, r)
        for k in keys:
            a, full = loc["l" + k[1:]], g[k]
            if packed:
                if s == 0:
                    o = offs.get(k, 0)
                    assert np.array_equal(a, full[o:o + a.shape[0]]), (k, r)
                    offs[k] = o + a.shape[0]
                continue
            bl, fl = a.shape[0], a.shape[1]
            assert np.array_equal(a, full[d * bl:(d + 1) * bl, s * fl:(s + 1) * fl]), (k, r)


TOL = {"float32": 1e-5, "float64": 1e-9}
LOG_TOL = {"float32": 1e-4, "float64": 1e-9}


def assert_rel(got, ref, tol: float, what=""):
    """max|got - ref| / max|ref| <= tol."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    r = np.abs(got - ref).max() / np.abs(ref).max() if ref.size else 0.0
    assert r <= tol, (what, r, tol)


def moments_close(got: dict, prefix: str, want, count_exact=True):
    np.testing.assert_allclose(got[prefix + "/0"], np.asarray(want.count), rtol=0, atol=0)
    np.testing.assert_allclose(got[prefix + "/1"], np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    std = np.sqrt(np.maximum(got[prefix + "/2"] / max(float(got[prefix + "/0"]), 1.0), 0))
    np.testing.assert_allclose(std, np.asarray(want.std), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ mesh cases --
def test_halo_left_matches_vorbis_batch(port):
    """Time-sharded vorbis framing == the JAX shard_map on the same mesh and
    == the single-device frames (pre-npad layout)."""
    cfg = jcfg_of("halo_left")
    _, (sig, _, _) = inputs("halo_left")
    out = jax.jit(shard_map(lambda x: jhalo.sharded_stft_vorbis_power(x, cfg, "seq"),
                            mesh=jmesh(port), in_specs=JP("data", "seq"),
                            out_specs=JP("data", "seq")))(jnp.asarray(sig))
    got = port[2]("halo_left")["g/power/0"]
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-12, atol=1e-15)
    frames = JS._vorbis_frames(jnp.asarray(sig), cfg)
    xr, xi = m.ops.spectrum.rdft(frames, cfg, windowed=True)
    np.testing.assert_allclose(got, np.asarray((xr * xr + xi * xi) * cfg.wnorm ** 2),
                               rtol=1e-12, atol=1e-15)
    check_blocks(port, "halo_left", "power")


def _step_vs_jax(port, case, tag="step", feature="mfcc"):
    cfg = jcfg_of(case)
    _, (sigs, lengths, _) = inputs(case)
    jf, jmask, jmom = jdata.extraction_step(sigs, lengths, cfg, jmesh(port), feature)
    g = port[2](case)
    mask = np.asarray(jmask)
    np.testing.assert_array_equal(g[f"g/{tag}/1"], mask)
    got = g[f"g/{tag}/0"]
    assert got.shape == np.asarray(jf).shape
    tol = LOG_TOL if feature in ("mfcc", "lmfe") else TOL
    assert_rel(got[mask], np.asarray(jf)[mask], tol[cfg.dtype], case)
    moments_close(g, f"g/{tag}/2", jmom)
    check_blocks(port, case, tag)
    return g, cfg, sigs, lengths


def test_extraction_step_matches_pipeline(port):
    g, cfg, sigs, lengths = _step_vs_jax(port, "pipeline")
    n_valid = (sigs.shape[1] - cfg.frame_size) // cfg.frame_step
    assert g["g/step/1"].sum() == len(sigs) * n_valid
    pcfg = P.from_reference(dataclasses.asdict(cfg))
    single = P.features.mfcc(torch.from_numpy(sigs), pcfg).numpy()
    np.testing.assert_allclose(g["g/step/0"][:, :n_valid], single[:, :n_valid], rtol=1e-4,
                               atol=1e-4)
    valid = g["g/step/0"][g["g/step/1"]]
    np.testing.assert_allclose(g["g/step/2/1"] * g["g/step/2/0"], valid.sum(0), rtol=1e-4)


def test_extraction_step_ragged_lengths(port):
    """Masked moments == unpadded per-utterance statistics; each row ==
    the float64 speechpy oracle at the reference's 3e-3 gate."""
    g, cfg, sigs, lengths = _step_vs_jax(port, "ragged")
    counts = [int((L - cfg.frame_size) // cfg.frame_step) for L in lengths]
    assert g["g/step/1"].sum(axis=1).tolist() == counts
    allv = []
    for i, L in enumerate(lengths):
        gold = sp.mfcc(sigs[i, :L].astype(np.float64), 16000)
        np.testing.assert_allclose(g["g/step/0"][i, :counts[i]], gold[:counts[i]], rtol=3e-3,
                                   atol=3e-3)
        allv.append(g["g/step/0"][i, :counts[i]])
    allv = np.concatenate(allv)
    np.testing.assert_allclose(g["g/step/2/1"], allv.mean(0), rtol=1e-4, atol=1e-5)


def test_extraction_step_melspec(port):
    """Sharded vorbis mel == JAX on the same mesh; after the global n_pad
    layout == the batch mel_spectrogram; packed input and packed rows
    too."""
    g, cfg, sigs, lengths = _step_vs_jax(port, "melspec", feature="melspec")
    laid = np.asarray(JS._apply_npad_layout(jnp.asarray(g["g/step/0"]), cfg))
    batch = np.asarray(m.features.mel_spectrogram(jnp.asarray(sigs), cfg))
    np.testing.assert_allclose(np.swapaxes(laid, -1, -2), batch, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g["g/packed/0"], g["g/step/0"], rtol=1e-6, atol=1e-6)
    counts = g["g/step/1"].sum(axis=1)
    off = 0
    for r, c in enumerate(counts):
        np.testing.assert_array_equal(g["g/rows/0"][off:off + c], g["g/packed/0"][r, :c])
        off += c
    assert g["g/rows/0"].shape[0] == off
    check_blocks(port, "melspec", "packed")
    check_blocks(port, "melspec", "rows", packed=True)


def test_extraction_step_ssc(port):
    g, cfg, sigs, lengths = _step_vs_jax(port, "ssc", feature="ssc")
    assert int(g["g/step/2/0"]) == int(g["g/step/1"].sum())


def test_extraction_step_multi_feature(port):
    """Tuple feature == JAX's, == the port's per-feature steps, with
    per-feature moments; melspec and unknown heads are refused."""
    heads = ("mfcc", "lmfe", "mfe", "ssc", "energy")
    cfg = jcfg_of("multi")
    _, (sigs, lengths, _) = inputs("multi")
    jout, jmask, jmom = jdata.extraction_step(sigs, lengths, cfg, jmesh(port), heads)
    g = port[2]("multi")
    mask = np.asarray(jmask)
    np.testing.assert_array_equal(g["g/step/1"], mask)
    for h in heads:
        ref = jout[h][0] if h == "mfe" else jout[h]
        got = g[f"g/step/0/{h}/0" if h == "mfe" else f"g/step/0/{h}"]
        tol = LOG_TOL if h in ("mfcc", "lmfe") else TOL
        assert_rel(got[mask], np.asarray(ref)[mask], tol["float32"], h)
        moments_close(g, f"g/step/2/{h}", jmom[h])
    np.testing.assert_allclose(g["g/step/0/mfe/1"], g["g/step/0/energy"], rtol=1e-7)
    for h in ("mfcc", "lmfe", "ssc"):
        np.testing.assert_array_equal(g[f"g/{h}/1"], mask)
        np.testing.assert_allclose(g[f"g/step/0/{h}"][mask], g[f"g/{h}/0"][mask], rtol=1e-5,
                                   atol=1e-5)
    assert "melspec" in str(g["err/melspec"]) and "unknown features" in str(g["err/plp"])
    check_blocks(port, "multi", "step")


def _packed_vs_padded_jax(port, case, which):
    cfg = jcfg_of(case)
    _, (sigs, lengths, clips) = inputs(case)
    b_pad = 8 if case == "packed" else 4
    flat, offs, lens = jdata.pack_signals(clips, b_pad, None)
    pad = np.zeros((b_pad, sigs.shape[1]), np.float32)
    pad[:len(clips)] = sigs
    ref = jdata.extraction_step(pad, lens, cfg, jmesh(port), which)
    g = port[2](case)
    assert str(g["flat_dtype"]) == str(flat.dtype)
    mask = np.asarray(ref[1])
    np.testing.assert_array_equal(g["g/step/1"], mask)
    return g, ref, mask


def test_extraction_step_packed_matches_padded(port):
    """Packed input (int16 flat buffer, padding rows) == JAX's step on the
    host-padded batch."""
    g, (jf, _, jmom), mask = _packed_vs_padded_jax(port, "packed", "mfcc")
    assert str(g["flat_dtype"]) == "int16"
    assert_rel(g["g/step/0"][mask], np.asarray(jf)[mask], LOG_TOL["float32"])
    moments_close(g, "g/step/2", jmom)
    check_blocks(port, "packed", "step")


def test_extraction_step_packed_f32_fallback(port):
    """Clips off the PCM16 grid take a float32 flat buffer."""
    g, (jf, _, jmom), mask = _packed_vs_padded_jax(port, "packed_f32", "mfcc")
    assert str(g["flat_dtype"]) == "float32"
    assert_rel(g["g/step/0"][mask], np.asarray(jf)[mask], LOG_TOL["float32"])
    moments_close(g, "g/step/2", jmom)


def test_extraction_step_packed_multi(port):
    which = ("mfcc", "lmfe", "energy")
    g, (jout, _, jmom), mask = _packed_vs_padded_jax(port, "packed_multi", which)
    for h in which:
        tol = LOG_TOL if h in ("mfcc", "lmfe") else TOL
        assert_rel(g[f"g/step/0/{h}"][mask], np.asarray(jout[h])[mask], tol["float32"], h)
        moments_close(g, f"g/step/2/{h}", jmom[h])


def test_extraction_step_hop_misaligned_frames(port):
    """25/10 ms frames (400/160) in float64 == JAX and the float64 oracle."""
    g, cfg, sigs, lengths = _step_vs_jax(port, "hop_misaligned")
    for i, L in enumerate(lengths):
        n_valid = int(g["g/step/1"][i].sum())
        gold = sp.mfcc(sigs[i, :L], 16000, frame_length=0.025)
        assert n_valid == gold.shape[0]
        np.testing.assert_allclose(g["g/step/0"][i, :n_valid], gold, rtol=1e-7, atol=1e-9)


def test_packed_output_matches_padded_rows(port):
    """frame_counts= packed outputs: rank 0's gathered buffer holds exactly
    the valid rows of JAX's padded step (JAX's buffer is that, then a zero
    tail), in corpus order; moments as JAX's; the multi-feature tree through
    the unpacked-signal entry point too."""
    cfg = jcfg_of("packed_rows")
    _, (sigs, lengths, clips) = inputs("packed_rows")
    flat, offs, lens = jdata.pack_signals(clips, 8, None)
    counts = jdata.frame_counts_host(lens, cfg, "mfcc")
    jm = jmesh(port)
    pk, jmom = jdata.extraction_step_packed(flat, offs, lens, sigs.shape[1], cfg, jm, "mfcc",
                                            frame_counts=counts)
    pk = np.asarray(pk)
    g = port[2]("packed_rows")
    got = g["g/rows/0"]
    total = int(counts.sum())
    assert got.shape == (total, 13) and not pk[total:].any()
    assert_rel(got, pk[:total], LOG_TOL["float32"])
    moments_close(g, "g/rows/1", jmom)
    pad = np.zeros((8, sigs.shape[1]), np.float32)
    pad[:4] = sigs
    which = ("mfcc", "mfe", "energy")
    jout, _ = jdata.extraction_step(pad, lens, cfg, jm, which, frame_counts=counts)
    for h in which:
        ref = np.asarray(jout[h][0] if h == "mfe" else jout[h])[:total]
        key = f"g/multi_rows/0/{h}/0" if h == "mfe" else f"g/multi_rows/0/{h}"
        assert_rel(g[key], ref, (LOG_TOL if h == "mfcc" else TOL)["float32"], h)
    check_blocks(port, "packed_rows", "rows", packed=True)
    check_blocks(port, "packed_rows", "multi_rows", packed=True)


def test_packed_output_wire_f16(port):
    """float16 wire: bitwise the float32 packed outputs cast to float16 (the
    cast is the only difference), so |err| <= 2^-11 |x|; moments identical;
    every head of a multi-feature tree too."""
    g = port[2]("wire_f16")
    ref, out = g["g/rows/0"], g["g/f16/0"]
    assert out.dtype == np.float16
    np.testing.assert_array_equal(out, ref.astype(np.float16))
    d = np.abs(out.astype(np.float32) - ref)
    assert (d <= np.abs(ref) * 2.0 ** -11 + 1e-6).all()
    np.testing.assert_array_equal(g["g/f16/1/1"], g["g/rows/1/1"])
    for k in g:
        if k.startswith("g/m16/0/"):
            assert g[k].dtype == np.float16
            np.testing.assert_array_equal(g[k], g["g/m32" + k[5:]].astype(np.float16))
        if k.startswith("g/m16/1/"):
            assert g[k].dtype == np.float32
    check_blocks(port, "wire_f16", "f16", packed=True)


def test_unpack_resample_matches_padded(port):
    """Packed source-rate buffer + device unpack/resample == JAX's on the
    same mesh, and == the padded host batch through resample_poly."""
    from mfcc_rust_tpu.ops.resample import resample_poly

    _, (sigs, lengths, clips) = inputs("resample")
    flat, offs, lens = jdata.pack_signals(clips, 4, None)
    ref = np.asarray(jdata.unpack_resample(flat, offs, lens, sigs.shape[1], 2, 1, jmesh(port)))
    n_data, n_seq, load = port
    rows = []
    for d in range(n_data):
        rows.append(load("resample", d * n_seq)["l/sig"])
    got = np.concatenate(rows)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    direct = np.asarray(jax.jit(resample_poly, static_argnums=(1, 2))(jnp.asarray(sigs), 2, 1))
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-7)


def test_all_cases_ran(port):
    for case in CASES:
        for r in range(4):
            assert port[2](case, r)


# ------------------------------------------------------------ unit cases --
def test_corpus_normalize_matches_cmvn():
    """Corpus moments over ONE utterance reduce to the reference's global
    cmvn, as JAX's do."""
    feat = np.random.default_rng(10).normal(1.0, 2.0, (200, 13))
    mom = pstats.local_moments(torch.from_numpy(feat))
    ours = mom.normalize(torch.from_numpy(feat), True).numpy()
    np.testing.assert_allclose(ours, sp.cmvn(feat, True), rtol=1e-6, atol=1e-7)
    jmom = jstats.local_moments(jnp.asarray(feat))
    np.testing.assert_allclose(ours, np.asarray(jmom.normalize(jnp.asarray(feat), True)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("float64", 1e-12)])
@pytest.mark.parametrize("masked", [False, True])
def test_local_moments_match_jax(dtype, rtol, masked):
    rng = np.random.default_rng(11)
    x = rng.normal(3.0, 2.0, (4, 50, 13)).astype(dtype)
    mask = rng.random((4, 50)) > 0.3 if masked else None
    ours = pstats.local_moments(torch.from_numpy(x),
                                None if mask is None else torch.from_numpy(mask))
    ref = jstats.local_moments(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=0)


def test_merge_and_tree_merge_bitwise_equal_to_jax():
    """On numpy states both packages' merge and tree_merge are the same
    operators in the same order: bitwise equal, and deterministic."""
    rng = np.random.default_rng(12)
    parts = []
    for i in range(5):
        x = rng.normal(i, 1.0 + i, (40 + 7 * i, 13)).astype(np.float32)
        parts.append((np.float32(x.shape[0]), x.mean(0), ((x - x.mean(0)) ** 2).sum(0)))
    ours = [pstats.CorpusMoments(*p) for p in parts]
    ref = [jstats.CorpusMoments(*p) for p in parts]
    a = pstats.tree_merge(ours)
    b = jstats.tree_merge(ref)
    for u, v in zip(a, b):
        assert isinstance(u, (np.ndarray, np.floating)) and np.array_equal(u, v)
    for u, v in zip(ours[0].merge(ours[1]), ref[0].merge(ref[1])):
        assert np.array_equal(u, v)
    assert all(np.array_equal(u, v) for u, v in zip(a, pstats.tree_merge(ours)))
    assert float(a.count) == sum(float(p[0]) for p in parts)
    with pytest.raises(ValueError):
        pstats.tree_merge([])


def test_frame_pack_args_raises_past_int32():
    """Frame counts summing to 2**31 or more raise ValueError (the
    reference's int32 cumsum would wrap silently)."""
    with pytest.raises(ValueError, match="frame offset"):
        pdata._frame_pack_args(np.array([2**30, 2**30], np.int64))
    with pytest.raises(ValueError, match="frame offset"):
        pdata._frame_pack_args(np.array([2**31 - 1, 1, 5], np.int64))
    offs, total = pdata._frame_pack_args(np.array([3, 0, 2**31 - 5], np.int64))
    assert offs.tolist() == [0, 3, 3] and total == 2**31 - 2
    jo, _ = jdata._frame_pack_args(np.array([5, 0, 7, 1]), None)
    po, pt = pdata._frame_pack_args(np.array([5, 0, 7, 1]))
    assert np.array_equal(jo, po) and pt == 13


def test_fetch_outputs_single_transfer_roundtrip():
    """The one-copy fetch reproduces every leaf exactly (f32/bool trees) and
    falls back per leaf for float64."""
    rng = np.random.default_rng(13)
    feats = torch.from_numpy(rng.normal(0, 1, (4, 7, 13)).astype(np.float32))
    mask = torch.from_numpy(rng.random((4, 7)) > 0.5)
    mom = pstats.CorpusMoments(torch.tensor(28.0),
                               torch.from_numpy(rng.normal(0, 1, 13).astype(np.float32)),
                               torch.from_numpy(np.abs(rng.normal(0, 1, 13)).astype(np.float32)))
    tree = ({"a": feats, "mfe": (feats, mask)}, mask, mom)
    out = pdata.fetch_outputs(tree)
    assert isinstance(out[2], pstats.CorpusMoments)
    got = torch.utils._pytree.tree_leaves(out)
    for a, b in zip(got, torch.utils._pytree.tree_leaves(tree)):
        assert isinstance(a, np.ndarray) and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    out64 = pdata.fetch_outputs((feats.double(), mask))
    assert out64[0].dtype == np.float64
    np.testing.assert_array_equal(out64[0], feats.double().numpy())


def test_fetch_outputs_wire16_roundtrip():
    """16-bit leaves (odd and even sizes) ride the f32 buffer two to a slot
    and come back bit-exact beside f32/bool leaves (bfloat16 as a CPU
    tensor: numpy has no bfloat16)."""
    rng = np.random.default_rng(14)
    h16 = torch.from_numpy(rng.normal(0, 1, (3, 5, 13)).astype(np.float16))  # odd
    h16e = torch.from_numpy(rng.normal(0, 1, (4, 8)).astype(np.float16))  # even
    b16 = torch.from_numpy(rng.normal(0, 1, 7).astype(np.float32)).to(torch.bfloat16)
    f32 = torch.from_numpy(rng.normal(0, 1, (2, 9)).astype(np.float32))
    mask = torch.from_numpy(rng.random(11) > 0.5)
    tree = {"a": h16, "b": (h16e, b16), "c": f32, "m": mask}
    out = pdata.fetch_outputs(tree)
    assert isinstance(out["b"][1], torch.Tensor) and out["b"][1].dtype == torch.bfloat16
    assert torch.equal(out["b"][1], b16)
    for k, want in (("a", h16), ("c", f32), ("m", mask)):
        assert out[k].dtype == want.numpy().dtype
        np.testing.assert_array_equal(out[k], want.numpy())
    np.testing.assert_array_equal(out["b"][0], h16e.numpy())


def test_port_config_fingerprint_equals_reference():
    """The checkpoint fingerprint hashes the config's fields: both packages'
    FeatureConfig give the same digest, so checkpoints cross packages."""
    from mfcc_rust_tpu.parallel.runner import _config_fingerprint as jfp

    from mfcc_rust_tpu_torch.parallel.runner import _config_fingerprint as pfp

    for jc in (m.FeatureConfig(sample_rate=16000), m.speechpy_config(8000, num_filters=26)):
        pc = P.from_reference(dataclasses.asdict(jc))
        assert pfp(pc, 10, 13) == jfp(jc, 10, 13)
    assert pfp(P.FeatureConfig(sample_rate=16000), 1, 13).startswith("e4e84e33f6209dcd")
