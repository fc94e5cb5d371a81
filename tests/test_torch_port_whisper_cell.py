"""The benchmark cell of Whisper large-v3's log-mel front end on the CPU
(``whisper_logmel128_16k.padded_b64x30s``): the benchmark's reference
(``benchmark/reference/whisper_ref.py``) against the tests' float64 oracle
and free of the program, the driver (``benchmark/drivers/device_whisper.py``:
its batches and the comparison that decides ``correct``) against the TF32
control and four faults at a tiny traffic, the configuration's and the
traffic's files, and the readers of the cell's four new metrics."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import features as PF
from tests.golden import whisper_ref as golden

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.append(_p)

from benchkit import card, cell, compare, spec, trace  # noqa: E402
from reference import whisper_ref  # noqa: E402

CELL = "whisper_logmel128_16k.padded_b64x30s"
CONF = json.loads((BENCH / "configs" / "whisper_logmel128_16k.json").read_text())
NEW_METRICS = ("whisper.k2_roofline", "whisper.finish_roofline", "whisper.finish_us",
               "whisper.launches_per_call")


def _small(rows=3, seconds=3.0):
    c = spec.cell(CELL)
    return dataclasses.replace(c, traffic={**c.traffic, "rows": rows, "seconds_of_audio": seconds,
                                           "median_s": seconds / 3, "max_s": seconds,
                                           "warm_cycles": 1, "pick_range": 20,
                                           "slice_calls": 20})


# ------------------------------------------------------------ reference --
@pytest.mark.parametrize("n_mels", [80, 128])
def test_reference_is_the_float64_oracle_in_blocks(n_mels):
    x = np.random.default_rng(31).normal(0, 0.1, (5, 24_000))
    x[2:, 8_000:] = 0.0
    want = golden.log_mel_spectrogram(x, n_mels)
    got = whisper_ref.whisper_log_mel(torch.from_numpy(x), n_mels, block_rows=2)
    assert got.dtype == torch.float64 and tuple(got.shape) == (5, n_mels, 150)
    assert (got - want).abs().max().item() <= 1e-12
    padded = whisper_ref.whisper_log_mel(torch.from_numpy(x[0]), n_mels, padding=800)
    assert (padded - golden.log_mel_spectrogram(x[0], n_mels, padding=800)).abs().max() <= 1e-12


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "from reference import whisper_ref\n"
            "import torch\n"
            "whisper_ref.whisper_log_mel(torch.zeros(2, 4000), 80)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('mfcc_rust_tpu_torch', 'mfcc_rust_tpu', 'jax')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------- batches --
def test_batches_are_noise_then_zeros_from_the_seed():
    c = _small(rows=4, seconds=3.0)
    drv = spec.driver("device_whisper")
    lengths = drv.true_lengths(2 ** 33 + 7, c.traffic, (4, 4), 16_000)
    assert lengths.shape == (4, 4) and lengths.min() >= 16_000 and lengths.max() <= 48_000
    assert np.array_equal(lengths, drv.true_lengths(2 ** 33 + 7, c.traffic, (4, 4), 16_000))
    ctx = cell.Context(c, 2 ** 33 + 7, torch.device("cpu"))
    d = drv.Driver(ctx)
    d.setup()
    assert len(d.xs) == 4 and tuple(d.xs[0].shape) == (4, 48_000)
    for b, x in enumerate(d.xs):
        for r in range(4):
            n = int(d.lengths[b, r])
            assert bool((x[r, n:] == 0).all())
            assert float(x[r, :n].std()) > 0.05 and float(x[r].abs().max()) <= 1.0


def test_full_traffic_lengths_follow_the_corpus_profile():
    t = spec.cell(CELL).traffic
    s = spec.driver("device_whisper").true_lengths(2 ** 31 + 9, t, (4, 64), 16_000) / 16_000
    assert 1.0 <= s.min() and s.max() <= 30.0 and 3.0 < float(np.median(s)) < 12.0


# ------------------------------------------------- what decides correct --
@pytest.mark.parametrize("seed", [2 ** 31 + 51, 2 ** 33 + 52])
def test_program_is_correct_and_the_control_is_not(seed):
    c = _small(rows=4, seconds=4.0)
    ctx = cell.Context(c, seed, torch.device("cpu"))
    drv = spec.driver(c.traffic["kind"]).Driver(ctx)
    drv.setup()
    drv.window(0.2)
    program = {k: v for k, v in drv.numbers("program").items() if not k.startswith("_")}
    control = {k: v for k, v in drv.numbers("control").items() if not k.startswith("_")}
    assert set(program) == set(c.limits) == set(CONF["compare"])
    assert compare.judge(program, c.limits)[0], program
    assert not compare.judge(control, c.limits)[0], control


def _half_zeroed(fn):
    def call(x, **kw):
        out = fn(x, **kw).clone()
        out[: out.shape[0] // 2] = 0.0
        return out
    return call


def _one_scaled(fn):
    """Every answer of the first batch the program sees, 5% off."""
    first = []

    def call(x, **kw):
        if not first:
            first.append(x.data_ptr())
        out = fn(x, **kw)
        return out * 1.05 if x.data_ptr() == first[0] else out
    return call


def _last_frame_kept(fn):
    def call(x, n_mels=80, device=None, **kw):
        cfg = PA._whisper_cfg(n_mels)
        mel = PF.mel_spectrogram_librosa(torch.as_tensor(x).to(device), cfg)
        return PF.whisper_finish(torch.cat([mel, mel[..., -1:]], -1))
    return call


def _global_max(mel):
    log = torch.log10(torch.clamp_min(mel[..., :-1], 1e-10))
    return ((torch.maximum(log, log.amax() - 8.0) + 4.0) / 4.0).contiguous()


FAULTS = {"half_the_batch_zeroed": _half_zeroed, "one_answer_scaled": _one_scaled,
          "last_frame_kept": _last_frame_kept, "global_maximum": None}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_whisper_log_mel_is_not_correct(fault, monkeypatch):
    # this test process holds JAX for the reference's own tests; the
    # harness's check of the measured process's modules is not what is
    # tested here
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    if fault == "global_maximum":
        monkeypatch.setattr(PF, "whisper_finish", _global_max)
    elif fault:
        monkeypatch.setattr(PA, "log_mel_spectrogram_whisper",
                            FAULTS[fault](PA.log_mel_spectrogram_whisper))
    rec = cell.run(_small(rows=4, seconds=4.0), 2 ** 31 + 61, 0.2, False, "cpu")
    assert rec["correct"] is (fault is None), rec["compared"]
    assert rec["attempted"] > 0 and set(rec["compared"]) == {"max_abs_err"}


def test_a_wrong_shape_or_a_non_finite_answer_reads_inf():
    drv = spec.driver("device_whisper")
    ref = torch.zeros(2, 80, 10, dtype=torch.float64)
    assert drv.abs_err(ref[..., :-1].float(), ref) == math.inf
    bad = ref.float().clone()
    bad[1, 3, 4] = float("nan")
    assert drv.abs_err(bad, ref) == math.inf
    assert drv.abs_err(ref.float() + 0.25, ref) == 0.25


# ------------------------------------------------------------ the files --
def test_config_is_whisper_large_v3s_front_end_through_its_entry():
    assert dataclasses.asdict(PA._whisper_cfg(128)) == CONF["feature_config"]
    assert CONF["api"] == {"function": "log_mel_spectrogram_whisper", "kwargs": {"n_mels": 128}}
    assert CONF["reference"] == {"function": "whisper_log_mel", "kwargs": {"n_mels": 128}}
    assert CONF["reduced"] == [] and CONF["kernel_events"] == ["ct_mel", "whisper_logmel"]
    fc = CONF["feature_config"]
    assert (fc["sample_rate"], fc["fft_points"], fc["frame_stride_samples"],
            fc["num_filters"]) == (16000, 400, 160, 128)
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}["whisper_logmel128_16k"]
    assert entry["source"] == CONF["source"] and len(entry["source"]) <= 200
    assert entry["reduced"] == []


def test_cell_is_listed_on_one_chip_with_its_metrics():
    c = spec.cell(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "device_whisper"
    assert (c.traffic["rows"], c.traffic["seconds_of_audio"], c.traffic["batches"]) == (64, 30.0, 4)
    assert (c.traffic["keep_picks"], c.traffic["slice_calls"]) == (4, 2000)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2
    names = {m["name"] for m in c.per_layer}
    assert set(NEW_METRICS) <= names
    assert not any(n.startswith(("graphs.", "bucketing.")) for n in names)
    for m in c.per_layer:
        assert m["moves"] in e2e, m["name"]
    (v,) = c.limits.values()
    assert 0 < v["limit"] < 0.01


# ------------------------------------------------------------- readers --
def _trace_ctx(calls=2):
    def op(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}

    ev = []
    for c in range(calls):
        t0 = 1000 * c
        ev += [op("reflection_pad1d_out_kernel", t0, 70),
               op("ct_mel_kernel", t0 + 70, 200),
               op("whisper_logmel_rowmax_kernel<true>", t0 + 270, 30),
               op("whisper_logmel_kernel", t0 + 300, 60)]

    class Ctx:
        trace = trace.Trace(ev, calls=calls)
        config = CONF
        work_shape = (64, 480_000)

    return Ctx


def test_the_finish_work_count_by_hand():
    m = spec.metric("whisper.finish_roofline")
    fc = CONF["feature_config"]
    # 2 rows of 32,000 samples: 201 centred frames, 200 kept, 128 mels
    assert m.work(2, 32_000, fc) == (6 * 2 * 128 * 200, 4 * 2 * 201 * 128 + 4 * 2 * 128 * 200)
    assert card.least_seconds(*m.work(64, 480_000, fc))[1] == "bytes"


def test_the_readers_split_a_calls_device_time():
    ctx = _trace_ctx()
    assert spec.metric("whisper.finish_us").read(ctx) == pytest.approx(90.0)
    fin = spec.metric("whisper.finish_roofline")
    least = fin.work(64, 480_000, CONF["feature_config"])[1] / card.PEAK_HBM_BYTES
    assert fin.read(ctx) == pytest.approx(100 * least / 90e-6)
    k2 = spec.metric("k2_roofline")
    kw = {"sr": 16000, "n_fft": 400, "hop_length": 160, "n_mels": 128}
    assert spec.metric("whisper.k2_roofline").kwargs(ctx) == kw
    least2, _ = card.least_seconds(*k2.work(64, 480_000, kw))
    assert spec.metric("whisper.k2_roofline").read(ctx) == pytest.approx(100 * least2 / 200e-6)
    assert k2.work(64, 480_000, kw)[1] == 4 * 64 * 480_000 + 4 * 64 * 3001 * 128
    glue = spec.metric("api.glue_device_us").read(ctx)
    assert glue == pytest.approx(70.0)
    ctx.trace = None
    assert all(spec.metric(n).read(ctx) is None
               for n in ("whisper.k2_roofline", "whisper.finish_roofline", "whisper.finish_us"))


def test_launches_per_call_reads_the_counters(monkeypatch):
    from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as wl

    read = spec.metric("whisper.launches_per_call").read
    monkeypatch.setattr(PA, "paths", PA.PathCount())
    monkeypatch.setattr(wl.whisper_logmel, "launches", 0)
    assert read(None) is None  # no call
    for _ in range(4):
        PA.paths.add(PA.PathCount.DIRECT)
    wl.whisper_logmel.launches = 8
    assert read(None) == 2.0


def test_launches_per_call_reads_none_from_a_program_without_the_kernel(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfcc_rust_tpu_torch.ops.cuda.whisper_logmel", None)
    assert spec.metric("whisper.launches_per_call").read(None) is None


# the share of K2's launches that staged the reflect pad: the Whisper cell's
# reader and the librosa cells'
REFLECT_SHARES = ("k2.reflect_share", "k2.reflect_share.host_paced")


@pytest.mark.parametrize("name", REFLECT_SHARES)
def test_reflect_share_reads_the_counters(monkeypatch, name):
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2

    read = spec.metric(name).read
    monkeypatch.setattr(k2.ct_mel, "launches", 0)
    monkeypatch.setattr(k2.reflect_launches, "launches", 0)
    ctx = _trace_ctx()  # the counters, not the trace, are read
    assert read(ctx) is None  # no launch
    k2.ct_mel.launches, k2.reflect_launches.launches = 8, 6
    assert read(ctx) == 0.75
    k2.reflect_launches.launches = 8
    assert read(ctx) == 1.0


@pytest.mark.parametrize("name", REFLECT_SHARES)
def test_reflect_share_reads_none_from_a_program_without_the_counter(monkeypatch, name):
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel as k2

    monkeypatch.setattr(k2.ct_mel, "launches", 5)
    # as at a commit before the counter: the module has no reflect_launches
    monkeypatch.delattr(k2, "reflect_launches")
    assert spec.metric(name).read(_trace_ctx()) is None


@pytest.mark.parametrize("name,cells", [
    ("k2.reflect_share", [CELL]),
    ("k2.reflect_share.host_paced", ["librosa_mel128_22k.device_b32x10s",
                                     "librosa_mel80_16k.device_b64x10s"])])
def test_reflect_share_is_listed_for_the_direct_k2_cells(name, cells):
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == name]
    assert m["workloads"] == cells and m["source"] == "program_counter"
    assert m["moves"] == ("audio_s_per_s.host_paced" if name.endswith("host_paced")
                          else "audio_s_per_s")
    for c in cells:
        assert name in {x["name"] for x in spec.cell(c).per_layer}
