"""The port's benchmark program (``bench_torch.py``) on the CPU, where no
line may print: the slope timer with an injected clock, the refusal without
CUDA, each timed line's function against the JAX package's on the same
seeded input, the correctness gate, the check of a kernel path against its
plain version, the metric names against ``bench.py``, the corpus wire
model's accounting and the scaling harness on a gloo world of two CPU
ranks.

Tolerances, as the port's test file of each function states them, on
seed 0 (the seed of tests/test_torch_port_features.py's cases): in float32
max|d| / max|ref| <= 1e-5 for the MFCC, MFE, SSC and the vorbis mel
(_features.py, _vorbis.py, _extract.py), 3e-5 for the log-MFE (_features.py:
the log turns a small band's float32 rounding into its relative error);
rtol 1e-4, atol 1e-6 for the librosa mel (_librosa.py).  In float64 the
same lines are held to 1e-9 (_features.py) and the librosa ones to rtol
1e-6, atol 0 (_librosa.py); they read 3e-16 to 2e-14 there, so what the
float32 cases read is float32 rounding: at seed 3 the MFCC reads 1.03e-5
in float32 and 7.9e-16 in float64.

The librosa MFCC is held in float32 at 3e-5 of max|ref|: _librosa.py's
elementwise rtol 1e-4, atol 1e-6 is finer than float32 resolves a cepstrum
near zero among values of magnitude ~30 (an element of 1,760 here needs an
rtol of 2.3e-4); in float64 it meets _librosa.py's rtol 1e-6, atol 0."""

import ast
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as B
import mfcc_rust_tpu as m
import mfcc_rust_tpu.api as japi
from mfcc_rust_tpu import features as JF
from tests.test_torch_port_parallel import run_world

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as F
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as k1
from mfcc_rust_tpu_torch.parallel import make_mesh
from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
from mfcc_rust_tpu_torch.runtime import write_wav

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "float64": 1e-9}
LOG_TOL = {"float32": 3e-5, "float64": 1e-9}
LIBROSA_TOL = {"float32": dict(rtol=1e-4, atol=1e-6), "float64": dict(rtol=1e-6, atol=0.0)}


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------- slope timer --
def test_slope_timer_linear_clock_gives_the_exact_rate():
    """A window of a + b reps seconds: the slope cancels a, so the rate is
    audio / b exactly, with no spread and no re-measure."""
    a, b = 2.0**-10, 2.0**-13
    seen = []

    def window(reps):
        seen.append(reps)
        return a + b * reps

    t = B._slope_timer(None, None, 10.0, window=window)
    assert t["value"] == 10.0 / b and t["rel_spread"] == 0.0
    assert t["ms"] == pytest.approx(1e3 * b)
    r2 = max(48, int(0.25 / ((a + 16 * b) / 16)))
    assert seen == [4, 16] + [r2, max(8, r2 // 5)] * 5
    assert t["calls"] == sum(seen)


# per round of 5 slopes, the noise on each slope's r2 window; the round kept
NOISY = [
    ([[0, .01, -.01, .02, -.02]], 0),  # tight at once
    ([[0, .3, -.3, .1, -.1], [0, .05, -.05, .01, 0]], 1),  # re-measured once
    ([[0, .3, -.3, .1, -.1], [0, .4, -.4, 0, 0], [0, .2, -.2, 0, 0]], 2),  # third tightest
    ([[0, .3, -.3, .1, -.1], [0, .2, -.2, 0, 0], [0, .5, -.5, 0, 0]], 1),  # second kept
]


@pytest.mark.parametrize("rounds,kept", NOISY, ids=["tight", "remeasured", "third", "second"])
def test_slope_timer_noisy_clock_keeps_the_tightest_median(rounds, kept):
    a, b, audio = 1e-3, 1e-4, 7.0
    noise = [n for r in rounds for n in r]
    seen = []

    def window(reps):
        seen.append(reps)
        k = len(seen) - 3  # the calls after the two calibration windows
        if k >= 0 and k % 2 == 0:  # an r2 window
            return a + b * reps * (1 + noise[k // 2])
        return a + b * reps

    t = B._slope_timer(None, None, audio, window=window)
    assert len(seen) == 2 + 10 * len(rounds)
    per = (a + 16 * b) / 16
    results = []
    for i, r in enumerate(rounds):
        r2 = max(48, int(0.25 * 2**i / per))
        r1 = max(8, r2 // 5)
        assert seen[2 + 10 * i: 12 + 10 * i] == [r2, r1] * 5
        vals = sorted(audio / ((a + b * r2 * (1 + n) - a - b * r1) / (r2 - r1)) for n in r)
        results.append((vals[2], (vals[-1] - vals[0]) / vals[2]))
    assert (t["value"], t["rel_spread"]) == pytest.approx(results[kept], rel=1e-12)
    assert t["rel_spread"] == min(s for _, s in results)
    assert all(s > 0.15 for _, s in results[:-1])


# ------------------------------------------------------------ no card --
@pytest.mark.parametrize("entry", ["main", "suite", "corpus", "scaling"])
def test_entry_points_refuse_without_cuda_and_print_nothing(entry, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    B._card.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(B, entry)()
    assert capsys.readouterr().out == ""


# ------------------------------------------------ each line against JAX --
def _jax_cfg(cfg):
    return m.FeatureConfig(**dataclasses.asdict(cfg))


def _close(feature, got, ref, dtype):
    if feature == "mel_spectrogram_librosa" or (feature == "mfcc_librosa"
                                                and dtype == "float64"):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **LIBROSA_TOL[dtype])
    else:
        assert rel(got, ref) <= (LOG_TOL if feature in ("lmfe", "mfcc_librosa")
                                 else TOL)[dtype], feature


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("key", list(B.LINES) + ["from_host"])
def test_line_matches_jax(key, dtype):
    """The function each timed line calls, at (2, one second) on the CPU,
    against the JAX package's function on the same seeded numpy input."""
    cfg, feature, _, _ = B.LINES["headline" if key == "from_host" else key]
    cfg = cfg.replace(dtype=dtype)
    x = np.random.default_rng(0).normal(0, 0.1, (2, cfg.sample_rate)).astype(dtype)
    if key == "from_host":
        got = P.mfcc(x, cfg.sample_rate, dtype=dtype, device="cpu")
        _close("mfcc", got, japi.mfcc(x, cfg.sample_rate, dtype=dtype), dtype)
        return
    got = B._call(feature, cfg)(torch.from_numpy(x))
    jcfg, jx = _jax_cfg(cfg), jnp.asarray(x)
    if isinstance(feature, tuple):
        ref = JF.extract(jx, jcfg, which=feature)
        for h in feature:
            pairs = zip(got[h], ref[h]) if h == "mfe" else [(got[h], ref[h])]
            for g, r in pairs:
                _close(h, g, r, dtype)
        return
    _close(feature, got, getattr(JF, feature)(jx, jcfg), dtype)


# ---------------------------------------------------------------- gate --
GATED = [("headline", "mfcc"), ("librosa", "mel_spectrogram_librosa"),
         ("vorbis", "mel_spectrogram"), ("librosa_mfcc", "mfcc_librosa"),
         ("multi", ("mfcc", "lmfe", "mfe", "ssc"))]


def _scaled(out, s):
    if isinstance(out, dict):
        return {k: _scaled(v, s) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(v * s for v in out)
    return out * s


@pytest.mark.parametrize("key,feature", GATED, ids=[g[0] for g in GATED])
def test_gate_passes_a_cpu_output_and_bites_at_one_percent(key, feature):
    cfg = B.LINES[key][0]
    limit = B.LIMIT.get(key, B.GATE)
    x = np.random.default_rng(5).normal(0, 0.1, (2, cfg.sample_rate)).astype(np.float32)
    out = B._call(feature, cfg)(torch.from_numpy(x))
    err = B.gate_err(feature, cfg, x, out)
    assert err <= limit and B._gate_fields(err, feature, limit)["gate"] == "pass"
    bad = B.gate_err(feature, cfg, x, _scaled(out, 1.01))
    assert bad > limit and B._gate_fields(bad, feature, limit)["gate"] == "fail"


def test_gate_error_raises_after_the_line():
    rec = {"metric": "m", "max_rel_err": 1e-2, "gate": "fail", "gate_rule": "r"}
    with pytest.raises(B.GateError):
        B._raise_on_gate(rec)
    B._raise_on_gate(dict(rec, gate="pass"))


# ---------------------------------------------------- plain kernels --
KERNEL_PATHS = [
    ("headline", lambda cfg: lambda x: F._MFCCKernel.apply(x, cfg, None), k1, "mfcc_fused"),
    ("prod_512", lambda cfg: lambda x: F._MelLibrosaKernel.apply(x, cfg), k2, "ct_mel"),
]


@pytest.mark.parametrize("key,path,mod,name", KERNEL_PATHS, ids=["K1", "K2"])
def test_plain_check_holds_the_kernel_path_to_its_plain_version(key, path, mod, name,
                                                                monkeypatch):
    """The kernel path of a line (the autograd function that calls the
    wrapper) against itself with the plain version in place: 0 where the
    wrapper is sound, 1e-2 where it is off by 1%, which the gate catches;
    the wrapper is back in place after each check."""
    cfg = B.LINES[key][0]
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 0.1, (3, 4000)).astype(np.float32))
    fn = path(cfg)
    wrapper = getattr(mod, name)
    assert B.plain_err(fn, x, fn(x)) == 0.0
    assert getattr(mod, name) is wrapper
    monkeypatch.setattr(mod, name, lambda *a: 1.01 * wrapper(*a))
    bad = B.plain_err(fn, x, fn(x))
    assert bad == pytest.approx(1e-2, rel=1e-3)
    assert getattr(mod, name) is not wrapper
    assert B._gate_fields(0.0, "mfcc", plain=bad)["gate"] == "fail"
    assert B._gate_fields(0.0, "mfcc", plain=B.PLAIN_TOL)["gate"] == "pass"


# --------------------------------------------------------- metric names --
def _templates(path: Path) -> set:
    """Every string literal of a source, an f-string with "{}" for each
    value it formats in (adjacent literals are already joined)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.JoinedStr):
            out.add("".join(v.value if isinstance(v, ast.Constant) else "{}"
                            for v in node.values))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
    return out


def test_metric_names_are_bench_py_s_letter_for_letter():
    ref = _templates(ROOT / "bench.py")
    for key, name in B.M.items():
        assert name in ref, key
    for key, name in B.NEW.items():
        assert name not in ref, key
    # the wire model keeps bench.py's name but the link law it states
    prefix, rest = B.NEW["wire"].split(" (")
    assert any(t.startswith(prefix + " (") and t.endswith(rest) and "law" in t for t in ref)


# ----------------------------------------------------------- wire model --
def test_wire_model_accounts_a_cpu_corpus_run(tmp_path):
    rng = np.random.default_rng(11)
    paths, total_audio, samples = [], 0.0, 0
    for i in range(8):
        clip = rng.normal(0, 0.1, int(rng.uniform(0.5, 2.5) * 16000)).astype(np.float32)
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, clip, 16000)
        paths.append(p)
        total_audio += len(clip) / 16000.0
        samples += len(clip)
    cfg = P.FeatureConfig(sample_rate=16000)
    batches = []
    r = CorpusRunner(paths, cfg, make_mesh(device="cpu"), batch_size=4,
                     out_dir=str(tmp_path / "out"), fetch_every=2, on_batch=batches.append)
    r.run()
    meter, wall = r.meter, 2.0
    link = {"h2d_fixed": 1e-4, "h2d_bw": 1e6, "d2h_fixed": 2e-3, "d2h_bw": 5e5}
    rec, ceiling = B.wire_model(wall, meter, "f32 wire", link, total_audio)
    c = meter.counters
    byte_s = c["h2d_bytes"] / 1e6 + c["d2h_bytes"] / 5e5
    frames = sum(np.load(tmp_path / "out" / (Path(p).stem + ".npy")).shape[0] for p in paths)
    assert rec["metric"] == "corpus wire model [f32 wire] (predicted vs measured link-busy seconds)"
    assert c["h2d_bytes"] >= 2 * samples  # int16 PCM up
    assert c["d2h_bytes"] >= 4 * 13 * frames  # float32 MFCC frames down
    assert rec["h2d"] == {"bytes_mb": round(c["h2d_bytes"] / 1e6, 2), "calls": len(batches)}
    assert rec["d2h"]["calls"] == c["fetch_groups"] >= len(batches) / 2
    assert rec["pred_link_byte_s"] == round(byte_s, 3)
    assert rec["pred_link_fixed_s"] == round(c["fetch_groups"] * 2e-3, 3)
    assert rec["pred_link_s"] == round(byte_s + c["fetch_groups"] * 2e-3, 3)
    busy = meter.span_union("dispatch", "fetch")
    assert rec["measured_link_busy_s"] == round(busy, 3)
    assert rec["pred_over_measured"] == round((byte_s + c["fetch_groups"] * 2e-3) / busy, 4)
    assert ceiling == pytest.approx(total_audio / byte_s)
    assert rec["value"] == round(total_audio / wall, 1)
    assert rec["link"] == {"h2d_fixed": 1e-4, "h2d_bw": 1.0, "d2h_fixed": 2e-3, "d2h_bw": 0.5}
    split = rec["wall_split_s"]
    assert sum(split.values()) == pytest.approx(wall, abs=5e-3)


# ----------------------------------------------------- scaling harness --
def test_scaling_on_a_gloo_world_of_two_prints_only_harness_lines(tmp_path):
    run_world("bench_scaling", tmp_path, 2)
    ranks = [json.loads((tmp_path / f"bench.rank{r}.json").read_text()) for r in range(2)]
    assert ranks[1]["stdout"] == "" and ranks[1]["lines"] == []
    lines = [json.loads(s) for s in ranks[0]["stdout"].splitlines()]
    assert lines == ranks[0]["lines"]
    assert [d["metric"] for d in lines] == [B.NEW["harness_data"].format(2),
                                            B.M["harness_halo"].format(2),
                                            B.M["harness_vorbis"]]
    for d in lines:
        assert d["metric"].startswith("HARNESS-VALIDATION") and d["unit"] == "ok"
        assert d["device"] == "cpu" and d["gate"] == "pass" and d["max_rel_err"] <= B.GATE
