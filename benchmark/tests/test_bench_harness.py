"""CPU tests of the benchmark's harness: the files it finds by name, the
traffic it makes from a seed, the frozen work counts, the reference, the
modules it loads, and its refusal to run without a card.

    python -m pytest benchmark/tests -q

Cases marked ``cuda`` run one short cell on the card and skip without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _cells import BENCH, CORPUS, ROOT, small  # noqa: E402
from benchkit import card, cell, compare, spec, trace  # noqa: E402
from reference import librosa_ref, pcm16, plain, speechpy_ref  # noqa: E402

SPEC = spec.benchmark()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


# ------------------------------------------------------------ the files --
def test_benchmark_json_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + WORKLOADS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(WORKLOADS)
    for w in WORKLOADS:  # every cell reports setup_s, another end-to-end metric and a layer
        c = spec.cell(w)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:  # ... whose end-to-end metric the cell reports
            assert m["moves"] in names, (w, m["name"])


@pytest.mark.parametrize("workload", WORKLOADS + [CORPUS])
def test_each_cell_finds_its_files_by_name(workload):
    c = spec.cell(workload) if workload != CORPUS else spec.make_cell(workload, *workload.split("."))
    assert c.config["feature_config"]["sample_rate"] > 0
    drv = spec.driver(c.traffic["kind"])
    assert hasattr(drv, "Driver")
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric(m["name"]).read)
    assert c.limits and all("limit" in v for v in c.limits.values())


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_is_the_config_the_entry_runs(config):
    from mfcc_rust_tpu_torch import api

    conf = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    kw = conf["api"]["kwargs"]
    if conf["api"]["function"] == "mfcc":
        built = api._speechpy_cfg(kw["sampling_frequency"])
    else:
        built = api._librosa_cfg(kw["sr"], kw.get("n_fft", 2048), kw.get("hop_length", 512), None,
                                 kw.get("n_mels", 128), 20, 0.0, None, 2.0, True)
    assert dataclasses.asdict(built) == conf["feature_config"]


# ------------------------------------------------------------ traffic --
@pytest.mark.parametrize("workload", [w for w in WORKLOADS if "device" in w])
def test_device_traffic_is_the_same_from_the_same_seed(workload):
    def inputs(seed):
        ctx = cell.Context(small(workload), seed, torch.device("cpu"))
        d = spec.driver("device_loop").Driver(ctx)
        d.setup()
        return torch.stack(d.xs)

    a, b, c = inputs(2 ** 31 + 5), inputs(2 ** 31 + 5), inputs(2 ** 31 + 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0 and abs(float(a.std()) - 0.1) < 0.01


def test_corpus_lengths_are_the_dev_clean_profile():
    """The profile of ``chip_smoke.corpus_lengths`` on ``default_rng(0)``,
    pinned: clip(lognormal(ln 6 s, 0.6), 1, 35) s at 16 kHz, 2,703 clips."""
    traffic = small(CORPUS).traffic
    traffic = {**traffic, "files": 2703, "max_s": 35.0}
    drv = spec.driver("corpus")
    lens = drv.lengths(traffic, 16000)
    assert len(lens) == 2703 and sum(lens) == 304_581_366
    assert lens[:5] == [103522, 88684, 140977, 102236, 69612]
    assert (min(lens), max(lens)) == (16000, 560000)


def test_corpus_clips_are_the_same_from_the_same_seed():
    traffic = {**small(CORPUS).traffic, "files": 20}
    drv = spec.driver("corpus")
    la, pa = drv.clips(traffic, 16000, 2 ** 31 + 9, "cpu")
    lb, pb = drv.clips(traffic, 16000, 2 ** 31 + 9, "cpu")
    lc, pc = drv.clips(traffic, 16000, 2 ** 31 + 10, "cpu")
    assert la == lb and np.array_equal(pa, pb)
    assert sorted(la) == sorted(lc) and la != lc  # the same lengths, in another order
    assert pa.dtype == np.int16 and len(pa) == sum(la)


def test_pcm16_round_trip(tmp_path):
    from mfcc_rust_tpu_torch.runtime import read_wav

    pcm = np.array([0, 1, -1, 32767, -32768, 1234], np.int16)
    pcm16.write(tmp_path / "a.wav", pcm, 16000)
    y, sr = pcm16.read(tmp_path / "a.wav")
    assert sr == 16000 and np.array_equal(y, pcm / 32768.0)
    got, sr2 = read_wav(str(tmp_path / "a.wav"))  # the program decodes the same file alike
    assert sr2 == 16000 and np.array_equal(got, (pcm / 32768.0).astype(np.float32))


# ---------------------------------------------------------- work counts --
@pytest.mark.parametrize("metric,config,shape,flops,nbytes,bound", [
    ("k1_roofline", "speechpy_mfcc13_16k", (48, 160_000), 673_003_296.0, 33_211_008, "operations"),
    ("k2_roofline", "librosa_mel128_22k", (32, 220_500), 903_086_368.0, 35_285_504, "operations"),
    ("k2_roofline", "librosa_mel80_16k", (64, 160_000), 884_275_392.0, 61_460_480, "bytes"),
])
def test_frozen_work_counts(metric, config, shape, flops, nbytes, bound):
    conf = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    m = spec.metric(metric)
    got = m.work(*shape, conf["reference"]["kwargs"])
    assert got == (flops, nbytes)
    assert card.least_seconds(*got)[1] == bound


def test_filterbank_nonzeros():
    assert plain.filterbank_nonzeros("speechpy_mfcc", {"sample_rate": 16000}) == 210
    assert plain.filterbank_nonzeros("librosa_mel", {"sr": 22050}) == 2018
    assert plain.filterbank_nonzeros("librosa_mel", {"sr": 16000, "n_fft": 512,
                                                     "n_mels": 80}) == 500


# ------------------------------------------------------------ reference --
def test_reference_is_the_frozen_oracles():
    x = np.random.default_rng(3).normal(0, 0.1, (2, 9_000))
    got = plain.speechpy_mfcc(torch.from_numpy(x), 16000).numpy()
    for row in range(2):
        want = speechpy_ref.mfcc(x[row], 16000)
        assert np.abs(got[row] - want).max() <= 1e-11 * np.abs(want).max()
    got = plain.librosa_mel(torch.from_numpy(x), sr=16000, n_fft=512, hop_length=160,
                            n_mels=80).numpy()
    for row in range(2):
        want = librosa_ref.melspectrogram(x[row], 16000, 512, 160, None, 80)
        assert np.abs(got[row] - want).max() <= 1e-11 * np.abs(want).max()


def test_reference_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -12])
    assert plain.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_reference_agrees_with_the_port_on_the_cpu(config):
    """The port's plain CPU path against the reference at a small size,
    within the limit its cells hold the card's answers to."""
    from mfcc_rust_tpu_torch import api

    conf = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 0.1, (3, 12_000)).astype(np.float32))
    got = getattr(api, conf["api"]["function"])(x, device="cpu", **conf["api"]["kwargs"])
    ref = plain.FUNCTIONS[conf["reference"]["function"]](x, **conf["reference"]["kwargs"])
    limit = min(json.loads(p.read_text())["max_err"]["limit"]
                for p in (BENCH / "limits").glob(f"{config}.device_*.json"))
    assert compare.answer_err(conf["compare"], got, ref) <= limit


def test_comparisons_bite():
    ref = torch.linspace(1.0, 2.0, 50, dtype=torch.float64)
    assert compare.answer_err("rel_to_max", ref.float(), ref) < 1e-7
    assert compare.answer_err("rel_to_max", ref * 1.01, ref) > 5e-3
    assert compare.answer_err("mixed", ref[:-1], ref) == math.inf
    bad = ref.clone()
    bad[3] = float("nan")
    assert compare.answer_err("mixed", bad, ref) == math.inf
    ok, compared = compare.judge({"a": 1.0}, {"a": {"limit": 2.0}, "b": {"limit": 0}})
    assert not ok and compared["b"]["value"] is None


# ---------------------------------------------------------------- trace --
def test_trace_reads_busy_time_and_idle_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.SLICE, "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": trace.CALL, "ts": 10, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 12, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::k<1>((anon)::Args)",
           "ts": 20, "dur": 30},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "other", "ts": 80, "dur": 30}]
    t = trace.Trace(ev, calls=2)
    assert t.window_s == pytest.approx(110e-6) and t.busy_s == pytest.approx(70e-6)
    assert t.device_s("k<1>") == pytest.approx(30e-6) and t.count("k<1>", "other") == 2
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("void (anonymous namespace)::k<1>", "other")
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([20e-6, 20e-6])
    assert b["idle_gaps"][0][0].startswith(trace.SLICE)
    assert trace.Trace([ev[3]], calls=1).window_s == pytest.approx(30e-6)


# ------------------------------------------------------- what it loads --
def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jaxtyping", "mfcc_rust_tpu_torch.api", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not any(m in cell.forbidden_modules() for m in ("jaxtyping", "flaxen"))
    monkeypatch.setitem(sys.modules, "mfcc_rust_tpu.ops", sys)
    assert "mfcc_rust_tpu.ops" in cell.forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole run of a small cell in a fresh process, then the loaded
    modules' top-level names."""
    code = (f"import sys, dataclasses; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            "from benchkit import cell, spec\n"
            "c = spec.cell('speechpy_mfcc13_16k.device_b48x10s')\n"
            "c = dataclasses.replace(c, traffic={**c.traffic, 'rows': 2, 'seconds_of_audio': 0.5,"
            " 'warm_cycles': 1, 'pick_range': 20, 'slice_calls': 20})\n"
            "rec = cell.run(c, 1, 0.2, True, 'cpu')\n"
            "assert rec is not None and rec['correct'], rec\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "mfcc_rust_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mfcc_rust_tpu"}


def _run(cwd: Path, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                           "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_run_without_a_card_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(ROOT, env)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_run_from_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout


# ------------------------------------------------------------- the card --
@pytest.fixture
def on_card():
    why = card.missing(1)
    if why:
        pytest.skip(why)


@pytest.mark.cuda
def test_a_short_run_on_the_card(on_card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                          "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] and rec["device"]["platform"] == "gpu"
    assert 0 < rec["device"]["busy_s"] <= rec["device"]["window_s"]
    assert 0 < rec["metrics"]["k1_roofline"]["value"] < 100
    assert list(rec)[-1] == "compared"
