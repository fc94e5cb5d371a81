"""The benchmark cell of NeMo FastConformer's log-mel front end on the CPU
(``nemo_logmel128_16k.ragged_b64x35s``): the benchmark's reference
(``benchmark/reference/nemo_ref.py``) against the tests' float64 oracle and
free of the program, the driver (``benchmark/drivers/device_nemo.py``: its
ragged batches and the comparison that decides ``correct``) against the
TF32 control and five faults at a tiny traffic, the configuration's and the
traffic's files, and the readers of the cell's five new metrics."""

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
from tests.golden import nemo_ref as golden

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.append(_p)

from benchkit import card, cell, compare, spec, trace  # noqa: E402
from reference import nemo_ref  # noqa: E402

CELL = "nemo_logmel128_16k.ragged_b64x35s"
CONF = json.loads((BENCH / "configs" / "nemo_logmel128_16k.json").read_text())
NEW_METRICS = ("nemo.k2_roofline", "nemo.prologue_roofline", "nemo.finish_roofline",
               "nemo.finish_us", "nemo.launches_per_call")


def _small(rows=4, max_s=3.0):
    c = spec.cell(CELL)
    return dataclasses.replace(c, traffic={**c.traffic, "rows": rows, "seconds_of_audio": max_s,
                                           "median_s": max_s / 3, "max_s": max_s,
                                           "warm_cycles": 1, "pick_range": 20,
                                           "slice_calls": 8})


# ------------------------------------------------------------ reference --
@pytest.mark.parametrize("n_mels", [80, 128])
def test_reference_is_the_float64_oracle_in_blocks(n_mels):
    lens = np.array([24_000, 0, 1, 160, 8_000, 19_999])
    x = np.random.default_rng(61).normal(0, 0.1, (6, 24_000))
    for r, n in enumerate(lens):
        x[r, n:] = 0.0
    want, want_seq = golden.log_mel_spectrogram(x, lens, n_mels)
    got, seq = nemo_ref.nemo_log_mel(torch.from_numpy(x), torch.from_numpy(lens), n_mels,
                                     block_rows=4)
    assert got.dtype == torch.float64 and tuple(got.shape) == (6, n_mels, 151)
    assert torch.equal(seq, want_seq) and (got - want).abs().max().item() <= 1e-9


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "from reference import nemo_ref\n"
            "import torch\n"
            "nemo_ref.nemo_log_mel(torch.zeros(2, 4000), torch.tensor([4000, 100]), 80)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('mfcc_rust_tpu_torch', 'mfcc_rust_tpu', 'jax')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_driver_and_the_readers_import_nothing_of_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "from benchkit import spec\n"
            "spec.driver('device_nemo')\n"
            f"[spec.metric(n) for n in {NEW_METRICS!r}]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('mfcc_rust_tpu', 'jax')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------- batches --
def test_batches_are_ragged_noise_padded_to_their_longest_row():
    c = _small(rows=4, max_s=3.0)
    ctx = cell.Context(c, 2 ** 33 + 7, torch.device("cpu"))
    d = spec.driver("device_nemo").Driver(ctx)
    d.setup()
    assert len(d.xs) == 4 and d.lengths.shape == (4, 4)
    for b, (x, lens) in enumerate(d.xs):
        assert lens.dtype == torch.int64 and lens.tolist() == d.lengths[b].tolist()
        assert x.shape == (4, int(lens.max())) and 16_000 <= int(lens.min())
        for r in range(4):
            n = int(lens[r])
            assert bool((x[r, n:] == 0).all()) and float(x[r, :n].std()) > 0.05
            assert float(x[r].abs().max()) <= 1.0
    again = spec.driver("device_nemo").Driver(cell.Context(c, 2 ** 33 + 7, torch.device("cpu")))
    again.setup()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(d.xs, again.xs))
    other = spec.driver("device_nemo").Driver(cell.Context(c, 2 ** 33 + 8, torch.device("cpu")))
    other.setup()
    assert not torch.equal(other.xs[0][0], d.xs[0][0])


def test_the_window_counts_true_speech_and_records_the_batches():
    c = _small(rows=2, max_s=1.0)
    ctx = cell.Context(c, 2 ** 31 + 8, torch.device("cpu"))
    d = spec.driver("device_nemo").Driver(ctx)
    d.setup()
    d.call = lambda batch: batch  # the accounting alone: many cycles of the batches
    w = d.window(0.05)
    calls = w["units"]
    want = sum(int(d.lengths[i % 4].sum()) for i in range(calls)) / 16_000
    assert w["audio_s"] == pytest.approx(want) and calls > 4
    assert w["batches"] == [[int(x.shape[-1]), lens.tolist()] for x, lens in d.xs]


def test_full_traffic_lengths_are_drawn_from_the_corpus_profile():
    t = spec.cell(CELL).traffic
    draw = spec.driver("device_whisper").true_lengths
    lengths = draw(2 ** 31 + 9, t, (4, 64), 16_000)
    assert lengths.shape == (4, 64) and lengths.dtype == np.int64
    s = lengths / 16_000
    assert 1.0 <= s.min() and s.max() <= 35.0 and abs(float(np.median(s)) - 6.0) < 0.8
    assert abs(float(s.mean()) - 6.0 * math.exp(0.6 ** 2 / 2)) < 0.8  # the lognormal's mean
    assert (int(t["batches"]), int(t["rows"])) == (4, 64)
    # independent draws: another seed, other lengths and other batch maxima
    other = draw(2 ** 33 + 1, t, (4, 64), 16_000)
    assert not np.array_equal(np.sort(other, axis=None), np.sort(lengths, axis=None))
    assert not np.array_equal(np.sort(other.max(axis=1)), np.sort(lengths.max(axis=1)))


def test_the_driver_draws_its_lengths_from_the_seed():
    c = _small(rows=4, max_s=3.0)
    t = c.traffic
    for seed in (2 ** 31 + 10, 2 ** 33 + 11):
        d = spec.driver("device_nemo").Driver(cell.Context(c, seed, torch.device("cpu")))
        d.setup()
        want = spec.driver("device_whisper").true_lengths(seed, t, (4, 4), 16_000)
        assert np.array_equal(d.lengths, want)


# ------------------------------------------------- what decides correct --
@pytest.mark.parametrize("seed", [2 ** 31 + 51, 2 ** 33 + 52])
def test_program_is_correct_and_the_control_is_not(seed):
    c = _small()
    ctx = cell.Context(c, seed, torch.device("cpu"))
    drv = spec.driver(c.traffic["kind"]).Driver(ctx)
    drv.setup()
    drv.window(0.2)
    program = {k: v for k, v in drv.numbers("program").items() if not k.startswith("_")}
    control = {k: v for k, v in drv.numbers("control").items() if not k.startswith("_")}
    assert set(program) == set(c.limits) == set(CONF["compare"])
    assert compare.judge(program, c.limits)[0], program
    assert not compare.judge(control, c.limits)[0], control


def _finish_all_frames(mel, seq):
    return _finish(mel, torch.full_like(seq, mel.shape[-1]))


_finish = PF.nemo_finish


def _finish_biased(mel, seq):
    n = seq.clamp(max=mel.shape[-1]).double()
    return _finish(mel, seq) * torch.sqrt(n / (n - 1))[..., None, None].to(mel.dtype)


def _finish_unmasked(mel, seq):
    log = torch.log(mel + PF.NEMO_LOG_GUARD)
    n = seq.clamp(max=mel.shape[-1])[..., None, None]
    valid = torch.arange(mel.shape[-1]) < n
    mean = torch.where(valid, log, 0.0).sum(-1, keepdim=True) / n
    var = torch.where(valid, (log - mean) ** 2, 0.0).sum(-1, keepdim=True) / (n - 1)
    return ((log - mean) / (torch.sqrt(var) + PF.NEMO_STD_FLOOR)).contiguous()


def _cfg_fault(**change):
    real = PA._nemo_cfg

    def cfg(n_mels):
        return real(n_mels).replace(**change)
    return cfg


# the five faults: each patches the plain path the CPU run takes
FAULTS = {"lengths_ignored": ("nemo_finish", _finish_all_frames),
          "biased_deviation": ("nemo_finish", _finish_biased),
          "no_preemphasis": ("_nemo_cfg", _cfg_fault(preemphasis_cof=0.0)),
          "periodic_window": ("_nemo_cfg", _cfg_fault(window="hann")),
          "mask_left_out": ("nemo_finish", _finish_unmasked)}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_nemo_front_end_is_not_correct(fault, monkeypatch):
    # this test process holds JAX for the reference's own tests; the
    # harness's check of the measured process's modules is not what is
    # tested here
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    if fault:
        name, fn = FAULTS[fault]
        monkeypatch.setattr(PA if name == "_nemo_cfg" else PF, name, fn)
    rec = cell.run(_small(), 2 ** 31 + 61, 0.2, False, "cpu")
    assert rec["correct"] is (fault is None), rec["compared"]
    assert rec["attempted"] > 0 and set(rec["compared"]) == {"max_abs_err"}
    if fault:  # at least ten times the limit: the calibrated order, not its edge
        assert rec["compared"]["max_abs_err"]["value"] > 10 * rec["compared"]["max_abs_err"]["limit"]


def test_frame_counts_that_differ_read_inf():
    c = _small()
    ctx = cell.Context(c, 2 ** 31 + 62, torch.device("cpu"))
    d = spec.driver("device_nemo").Driver(ctx)
    d.setup()
    x, lens = d.xs[0]
    feats, seq = PA.log_mel_spectrogram_nemo(x, lens, device="cpu")
    d.kept = {0: (0, (feats, seq))}
    assert d.numbers()["max_abs_err"] < 1e-3
    d.kept = {0: (0, (feats, seq + 1))}
    assert d.numbers()["max_abs_err"] == math.inf
    d.kept = {0: (0, (feats[..., :-1], seq))}
    assert d.numbers()["max_abs_err"] == math.inf


# ------------------------------------------------------------ the files --
def test_config_is_parakeets_front_end_through_its_entry():
    assert dataclasses.asdict(PA._nemo_cfg(128)) == CONF["feature_config"]
    assert CONF["api"] == {"function": "log_mel_spectrogram_nemo", "kwargs": {"n_mels": 128}}
    assert CONF["reference"] == {"function": "nemo_log_mel", "kwargs": {"n_mels": 128}}
    assert CONF["reduced"] == []
    assert CONF["kernel_events"] == ["nemo_prologue", "ct_mel", "nemo_finish"]
    fc = CONF["feature_config"]
    assert (fc["sample_rate"], fc["fft_points"], fc["win_length_samples"],
            fc["frame_stride_samples"], fc["num_filters"], fc["window"], fc["pad_mode"],
            fc["preemphasis_cof"]) == (16000, 512, 400, 160, 128, "hann_sym", "constant", 0.97)
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}["nemo_logmel128_16k"]
    assert entry["source"] == CONF["source"] and len(entry["source"]) <= 200
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/nemo_logmel128_16k.json"


def test_cell_is_listed_on_one_chip_with_its_metrics():
    c = spec.cell(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "device_nemo"
    t = c.traffic
    assert (t["rows"], t["batches"], t["median_s"], t["sigma"], t["min_s"], t["max_s"]) == \
        (64, 4, 6.0, 0.6, 1.0, 35.0)
    assert (t["keep_picks"], t["slice_calls"]) == (4, 2000)
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e == {"audio_s_per_s", "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert set(NEW_METRICS) <= names
    assert {"api.enqueue_us", "api.glue_device_us", "device.idle_share",
            "api.direct_share"} <= names
    # the span burst (benchkit/spans.py) calls the entry point without lengths
    assert not names & {"api.entry_self_us", "api.direct_us"}
    assert not any(n.startswith(("graphs.", "bucketing.")) for n in names)
    for m in c.per_layer:
        assert m["moves"] in e2e, m["name"]
    (v,) = c.limits.values()
    assert 0 < v["limit"] < 0.05


# ------------------------------------------------------------- readers --
BATCHES = [[48_000, [48_000, 16_000]], [32_000, [32_000, 0]]]


def _trace_ctx(calls=2):
    def op(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}

    ev = []
    for c in range(calls):
        t0 = 1000 * c
        ev += [op("void nemo_prologue_kernel<true>(float const*)", t0, 40),
               op("void ct_mel_fft_kernel<256>(float const*)", t0 + 40, 200),
               op("void nemo_finish_stats_kernel<4>(float const*)", t0 + 240, 30),
               op("nemo_finish_kernel", t0 + 270, 60),
               op("Memset", t0 + 330, 5)]

    class Ctx:
        trace = trace.Trace(ev, calls=calls)
        config = CONF
        window = {"batches": BATCHES}

    return Ctx


def test_the_work_counts_by_hand():
    fc = CONF["feature_config"]
    pro = spec.metric("nemo.prologue_roofline")
    # each row's samples read, and written with the 512 of the pad that its frames read
    assert pro.work(48_000, [48_000, 16_000], fc) == (2 * 64_000,
                                                      4 * 64_000 + 4 * (64_000 + 2 * 512))
    fin = spec.metric("nemo.finish_roofline")
    # 301 frames of the padded batch; the rows need 301 and 101 of them
    assert fin.work(48_000, [48_000, 16_000], fc) == (8 * 402 * 128,
                                                      4 * 402 * 128 + 4 * 2 * 128 * 301)
    assert fin.work(32_000, [32_000, 0], fc)[0] == 8 * 201 * 128
    k2 = spec.metric("k2_roofline")
    kw = spec.metric("nemo.k2_roofline").kwargs(_trace_ctx())
    assert kw == {"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 128}
    ops, nbytes = spec.metric("nemo.k2_roofline").batch_work([48_000, 16_000], kw)
    assert (ops, nbytes) == tuple(a + b for a, b in zip(k2.work(1, 48_000, kw),
                                                        k2.work(1, 16_000, kw)))
    assert nbytes == 4 * 64_000 + 4 * (301 + 101) * 128
    assert card.least_seconds(*pro.work(400_000, [400_000] * 64, fc))[1] == "bytes"
    assert card.least_seconds(*fin.work(400_000, [400_000] * 64, fc))[1] == "bytes"


def test_the_readers_split_a_calls_device_time():
    ctx = _trace_ctx()
    fc = CONF["feature_config"]
    assert spec.metric("nemo.finish_us").read(ctx) == pytest.approx(90.0)

    def least(work):
        return np.mean([card.least_seconds(*work(s, lens, fc))[0] for s, lens in BATCHES])

    fin = spec.metric("nemo.finish_roofline")
    assert fin.read(ctx) == pytest.approx(100 * least(fin.work) / 90e-6)
    pro = spec.metric("nemo.prologue_roofline")
    assert pro.read(ctx) == pytest.approx(100 * least(pro.work) / 40e-6)
    k2 = spec.metric("nemo.k2_roofline")
    kw = k2.kwargs(ctx)
    want = np.mean([card.least_seconds(*k2.batch_work(lens, kw))[0] for _, lens in BATCHES])
    assert k2.read(ctx) == pytest.approx(100 * want / 200e-6)
    assert spec.metric("api.glue_device_us").read(ctx) == pytest.approx(5.0)
    ctx.window = {}
    assert all(spec.metric(n).read(ctx) is None
               for n in ("nemo.k2_roofline", "nemo.prologue_roofline", "nemo.finish_roofline"))
    ctx.trace = None
    assert all(spec.metric(n).read(ctx) is None for n in NEW_METRICS[:4])


def test_launches_per_call_reads_the_counters(monkeypatch):
    from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as nl

    read = spec.metric("nemo.launches_per_call").read
    monkeypatch.setattr(PA, "paths", PA.PathCount())
    monkeypatch.setattr(nl.nemo_prologue, "launches", 0)
    monkeypatch.setattr(nl.nemo_finish, "launches", 0)
    assert read(None) is None  # no call
    for _ in range(4):
        PA.paths.add(PA.PathCount.DIRECT)
    nl.nemo_prologue.launches, nl.nemo_finish.launches = 4, 8
    assert read(None) == 3.0


def test_launches_per_call_reads_none_from_a_program_without_the_kernels(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfcc_rust_tpu_torch.ops.cuda.nemo_logmel", None)
    assert spec.metric("nemo.launches_per_call").read(None) is None
