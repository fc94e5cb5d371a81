"""The benchmark cell of speechpy's four-head suite on the CPU
(``speechpy_suite4_16k.heads_b64x10s``): its plain reference
(``benchmark/reference/speechpy_suite.py``) against the float64 numpy
oracle, the port's ``api.extract`` against that reference, the comparison
that decides ``correct`` (the driver ``benchmark/drivers/device_heads.py``
and the committed limits) against the TF32 control and two faults, the
configuration's file, the frozen work count of ``extract_roofline`` and the
readers of the cell's trace metrics.  Also the float64 X_0 / X_{N/2} sums of
the plain chunk-GEMM path (``features._exact_edges_plain``), which the cell
forced."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from tests.golden import speechpy_ref as sp

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.append(_p)

from benchkit import card, cell, compare, replay_split, spec, trace  # noqa: E402
from reference import speechpy_suite  # noqa: E402

CELL = "speechpy_suite4_16k.heads_b64x10s"
CONF = json.loads((BENCH / "configs" / "speechpy_suite4_16k.json").read_text())
KW = CONF["reference"]["kwargs"]
HEADS = ("mfe", "lmfe", "ssc", "mfcc")


def _signal(rows, n, seed):
    return np.random.default_rng(seed).normal(0, 0.1, (rows, n))


def _small(rows=4, seconds=1.0):
    c = spec.cell(CELL)
    return dataclasses.replace(c, traffic={**c.traffic, "rows": rows, "seconds_of_audio": seconds,
                                           "warm_cycles": 1, "pick_range": 20,
                                           "slice_calls": 20})


# ------------------------------------------------------------ reference --
def test_reference_is_the_float64_oracle():
    x = _signal(2, 9_000, 31)
    got = speechpy_suite.speechpy_suite(torch.from_numpy(x), block_rows=1, **KW)
    for row in range(2):
        feat, energy = sp.mfe(x[row], 16000)
        want = {"mfe": feat, "energy": energy, "lmfe": sp.lmfe(x[row], 16000),
                "ssc": sp.ssc(x[row], 16000), "mfcc": sp.mfcc(x[row], 16000)}
        mine = {"mfe": got["mfe"][0][row], "energy": got["mfe"][1][row], "lmfe": got["lmfe"][row],
                "ssc": got["ssc"][row], "mfcc": got["mfcc"][row]}
        for name, w in want.items():
            m = mine[name].numpy()
            assert m.dtype == np.float64 and m.shape == w.shape, name
            assert np.abs(m - w).max() <= 1e-10 * np.abs(w).max(), name


def test_reference_blocks_do_not_change_it():
    x = torch.from_numpy(_signal(5, 4_000, 32))
    a = speechpy_suite.speechpy_suite(x, block_rows=2, **KW)
    b = speechpy_suite.speechpy_suite(x, block_rows=8, **KW)
    assert torch.equal(a["mfe"][0], b["mfe"][0]) and torch.equal(a["mfe"][1], b["mfe"][1])
    for h in ("lmfe", "ssc", "mfcc"):
        assert torch.equal(a[h], b[h]), h


# --------------------------------------------------- the port against it --
# The port's float32 answer against the float64 reference, each head by the
# number the cell judges it by.  The plain chunk-GEMM path rounds each
# product in float32 (a few ulps of a band's power: mfe 1e-5 relative to
# itself above 2% of the largest band, energy and SSC 1e-6); the logs turn
# a small band's rounding into its own relative error (lmfe, and mfcc
# through the DCT, 2e-5 of the largest magnitude).  Without the float64
# X_0 sum, frames whose DC term nearly cancels put lmfe at 3.6e-3 on a CPU
# run of 4 x 2 s.
EXTRACT_TOL = {"mfe_max_err": 1e-5, "energy_max_err": 1e-6, "ssc_max_err": 1e-6,
               "lmfe_max_err": 2e-5, "mfcc_max_err": 2e-5}


@pytest.mark.parametrize("seed", [41, 42])
def test_extract_of_the_four_heads_matches_the_reference(seed):
    drv = spec.driver("device_heads")
    x = torch.from_numpy(_signal(3, 24_000, seed).astype(np.float32))
    got = P.extract(x, device="cpu", **CONF["api"]["kwargs"])
    assert set(got) == set(HEADS)
    ref = speechpy_suite.speechpy_suite(x, **KW)
    errs = drv.errors(CONF["compare"], got, ref)
    assert set(errs) == set(EXTRACT_TOL)
    for name, tol in EXTRACT_TOL.items():
        assert errs[name] <= tol, (name, errs[name])


# ------------------------------------------------- what decides correct --
@pytest.mark.parametrize("seed", [2 ** 31 + 51, 2 ** 33 + 52])
def test_program_is_correct_and_the_control_is_not(seed):
    c = _small(rows=8, seconds=2.0)
    ctx = cell.Context(c, seed, torch.device("cpu"))
    drv = spec.driver(c.traffic["kind"]).Driver(ctx)
    drv.setup()
    drv.window(0.2)
    program = {k: v for k, v in drv.numbers("program").items() if not k.startswith("_")}
    control = {k: v for k, v in drv.numbers("control").items() if not k.startswith("_")}
    assert set(program) == set(c.limits) == set(CONF["compare"])
    assert compare.judge(program, c.limits)[0], program
    assert not compare.judge(control, c.limits)[0], control


def _zero_row(out):
    out = dict(out)
    lmfe = out["lmfe"].clone()
    lmfe[0] = 0.0  # one head, one row of the batch left out
    out["lmfe"] = lmfe
    return out


def _ssc_scaled(out):
    return {**out, "ssc": out["ssc"] * 1.05}


FAULTS = {"lmfe_row_zeroed": _zero_row, "ssc_scaled": _ssc_scaled}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_extract_is_not_correct(fault, monkeypatch):
    # this test process holds JAX for the reference's own tests; the
    # harness's check of the measured process's modules is not what is
    # tested here (benchmark/tests runs it in a process of its own)
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    if fault:
        real = PF.extract
        monkeypatch.setattr(PF, "extract", lambda *a, **k: FAULTS[fault](real(*a, **k)))
    rec = cell.run(_small(), 2 ** 31 + 61, 0.2, False, "cpu")
    assert rec["correct"] is (fault is None), rec["compared"]
    assert rec["attempted"] > 0 and set(rec["compared"]) == set(CONF["compare"])


def test_a_missing_or_broken_head_reads_inf():
    drv = spec.driver("device_heads")
    x = torch.from_numpy(_signal(2, 4_000, 7))
    ref = speechpy_suite.speechpy_suite(x, **KW)
    got = {k: v for k, v in ref.items() if k != "ssc"}
    errs = drv.errors(CONF["compare"], got, ref)
    assert errs["ssc_max_err"] == math.inf and errs["lmfe_max_err"] == 0.0
    bad = {**ref, "mfcc": ref["mfcc"][:, :-1]}
    assert drv.errors(CONF["compare"], bad, ref)["mfcc_max_err"] == math.inf


# ------------------------------------------------------------ the files --
def test_config_is_the_speechpy_cells_config_through_extract():
    from mfcc_rust_tpu_torch import api

    other = json.loads((BENCH / "configs" / "speechpy_mfcc13_16k.json").read_text())
    assert CONF["feature_config"] == other["feature_config"]
    assert CONF["reference"]["kwargs"] == other["reference"]["kwargs"]
    built = api._speechpy_cfg(CONF["api"]["kwargs"]["sampling_frequency"])
    assert dataclasses.asdict(built) == CONF["feature_config"]
    assert CONF["api"]["function"] == "extract" and CONF["reduced"] == []
    assert list(CONF["api"]["kwargs"]["which"]) == list(HEADS)


def test_cell_is_listed_on_one_chip_with_the_device_paced_rate():
    c = spec.cell(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "device_heads"
    assert (c.traffic["rows"], c.traffic["seconds_of_audio"], c.traffic["batches"]) == (64, 10.0, 4)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2
    names = {m["name"] for m in c.per_layer}
    assert {"extract_roofline", "extract.products_us", "extract.elementwise_us",
            "edge_sums_roofline", "graphs.glue_device_us", "extract.heads_kernel_share"} <= names
    for m in c.per_layer:
        assert m["moves"] in e2e, m["name"]
    for v in c.limits.values():
        assert 0 < v["limit"] <= 5e-3 and v["lower"] < v["limit"] < v["upper"]


# ---------------------------------------------------------- work counts --
def test_extract_roofline_work_count_by_hand():
    m = spec.metric("extract_roofline")
    # 2 rows of 2,000 samples: floor((2,000 - 320) / 160) = 10 frames a row
    n, bins, nnz, mels, cep = 512, 257, 210, 40, 13
    per_frame = (2.5 * n * 9  # the real FFT, 2.5 N log2 N
                 + 3 * bins  # the power
                 + 3 * 2 * nnz  # mel, SSC numerator, SSC denominator
                 + bins + mels  # the SSC's frequency weighting and division
                 + mels  # the logs
                 + 2 * mels * cep  # the DCT
                 + bins + 1)  # the frame energy and its log
    assert per_frame == 15_186
    assert m.work(2, 2_000, KW) == (20 * per_frame, 4 * 2 * 2_000 + 4 * 20 * (3 * mels + 1 + cep))


def test_edge_sums_roofline_work_count_by_hand():
    m = spec.metric("edge_sums_roofline")
    # 2 rows of 2,000 samples, 10 frames a row of 320 samples: a product and
    # two adds a sample, three floats a frame written
    assert m.work(2, 2_000, KW) == (20 * 3 * 320, 4 * 2 * 2_000 + 4 * 3 * 20)
    assert card.least_seconds(*m.work(64, 160_000, KW))[1] == "bytes"
    assert card.least_seconds(*spec.metric("extract_roofline").work(64, 160_000, KW))[1] == "bytes"


def test_the_trace_readers_split_a_calls_device_time():
    """Two calls: each operation goes under the span whose runtime call
    launched it (its correlation), a replayed graph's kernels under
    ``graphs.replay``; products, the graph's other operations and the glue
    add up to the device time a call."""
    def op(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    ev = []
    for c, t0 in enumerate((0, 1000)):
        k = 10 * c
        ev += [op("user_annotation", "graphs.fill", t0, 10),
               op("cuda_runtime", "cudaLaunchKernel", t0 + 1, 2, k + 1),
               op("user_annotation", "graphs.replay", t0 + 10, 5),
               op("cuda_runtime", "cudaGraphLaunch", t0 + 11, 3, k + 2),
               op("user_annotation", "graphs.copy_out", t0 + 15, 5),
               op("cuda_runtime", "cudaMemcpyAsync", t0 + 16, 2, k + 3),
               op("kernel", "elementwise_kernel<direct_copy>", t0 + 100, 8, k + 1),
               op("kernel", "sm80_xmma_gemm_f32f32_f32f32_f32_nn", t0 + 108, 60, k + 2),
               op("kernel", "elementwise_kernel<mul>", t0 + 168, 25, k + 2),
               op("kernel", "edge_sums_kernel", t0 + 193, 4, k + 2),
               op("gpu_memcpy", "Memcpy DtoD", t0 + 197, 10, k + 3)]

    class Ctx:
        trace = trace.Trace(ev, calls=2)
        config = CONF
        work_shape = (64, 160_000)

    setattr(Ctx, replay_split.ATTR, replay_split.split(ev, 2))
    prod = spec.metric("extract.products_us").read(Ctx)
    rest = spec.metric("extract.elementwise_us").read(Ctx)
    glue = spec.metric("graphs.glue_device_us").read(Ctx)
    assert (prod, rest, glue) == pytest.approx((60.0, 29.0, 18.0))
    assert prod + rest + glue == pytest.approx(Ctx.trace.device_s() * 1e6 / 2)
    least = spec.metric("extract_roofline").work(64, 160_000, KW)[1] / 3.35e12
    assert spec.metric("extract_roofline").read(Ctx) == pytest.approx(100 * least / 107e-6)
    Ctx.trace = None
    # a program with no graph spans, as on the CPU, splits nothing
    setattr(Ctx, replay_split.ATTR, replay_split.split([e for e in ev if e["cat"] != "user_annotation"], 2))
    assert all(spec.metric(n).read(Ctx) is None
               for n in ("extract_roofline", "extract.products_us", "extract.elementwise_us",
                         "graphs.glue_device_us"))


# ------------------------------------------------ the heads kernel's share --
def test_heads_kernel_share_is_the_heads_launches_over_the_edge_launches(monkeypatch):
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ke
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_heads as kh

    read = spec.metric("extract.heads_kernel_share").read
    monkeypatch.setattr(ke.edge_sums, "launches", 0)
    monkeypatch.setattr(kh.heads, "launches", 0)
    assert read(None) is None  # no product made
    ke.edge_sums.launches, kh.heads.launches = 8, 6
    assert read(None) == 0.75
    kh.heads.launches = 8
    assert read(None) == 1.0


def test_heads_kernel_share_reads_none_from_a_program_without_the_kernel(monkeypatch):
    from mfcc_rust_tpu_torch.ops.cuda import speechpy_edges as ke

    monkeypatch.setattr(ke.edge_sums, "launches", 5)
    # as at a commit before the kernel: its module cannot be imported
    monkeypatch.setitem(sys.modules, "mfcc_rust_tpu_torch.ops.cuda.speechpy_heads", None)
    assert spec.metric("extract.heads_kernel_share").read(None) is None


# ------------------------------------------ the float64 X_0 and X_{N/2} --
EDGE_CONFIGS = [("20/10", {}), ("25/10 r=3", {"frame_length": 0.025}), ("hann", {"window": "hann"}),
                ("preemph", {"preemphasis_cof": 0.97})]


@pytest.mark.parametrize("name,kw", EDGE_CONFIGS, ids=[c[0] for c in EDGE_CONFIGS])
def test_edge_sums_are_the_float64_sums_of_each_frame(name, kw):
    cfg = P.speechpy_config(16000, **kw)
    x = torch.from_numpy(_signal(2, 5_000, 71).astype(np.float32))
    n = (x.shape[-1] - cfg.frame_size) // cfg.frame_step
    c = PF._speechpy_tensors(cfg, x.device, x.dtype)
    ch, y = PF._chunk_gemm(x, c["wall"], n, cfg.frame_step)
    got = PF._exact_edges(x, ch, y.clone(), cfg, n)
    frames = x.double().unfold(-1, cfg.frame_size, cfg.frame_step)[..., :n, :]
    w = torch.as_tensor(PF.chunk_gemm_wall(cfg, True)["w"], dtype=torch.float64)
    alt = w * torch.tensor([(-1.0) ** t for t in range(w.numel())], dtype=torch.float64)
    k = PF.constant_bundle(cfg)["fbank_kmax"]
    for col, weights in ((0, w), (2 * k, w), (2 * k + 1, alt)):
        assert torch.equal(got[..., col], (frames @ weights).float()), (name, col)
    rest = [j for j in range(y.shape[-1]) if j not in (0, 2 * k, 2 * k + 1)]
    assert torch.equal(got[..., rest], y[..., rest]), name


def test_a_cancelling_dc_term_stays_exact_in_every_head():
    """Frames built so that X_0 sums to 1e-7 of its terms: the float32
    product's rounding of X_0 would be of its own size there."""
    rng = np.random.default_rng(72)
    x = rng.normal(0, 0.1, (2, 3_200))
    for f in range(0, 19, 2):  # every other frame of 320 samples, hop 160
        seg = x[:, f * 160:f * 160 + 320]
        seg[:, -1] -= seg.sum(-1) - 1e-7 * np.abs(seg).sum(-1)
    x = x.astype(np.float32).astype(np.float64)
    got = P.extract(torch.from_numpy(x.astype(np.float32)), 16000, which=HEADS, device="cpu")
    ref = speechpy_suite.speechpy_suite(torch.from_numpy(x), **KW)
    errs = spec.driver("device_heads").errors(CONF["compare"], got, ref)
    for name, tol in EXTRACT_TOL.items():
        assert errs[name] <= tol, (name, errs[name])
