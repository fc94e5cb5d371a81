"""The comparison that decides ``correct`` has to fail what it exists to
catch, on the CPU at a size a test run holds:

* the control, the reference in TF32 put in the program's place, fails
  each cell's limits, while the program passes them;
* a whole run with the timed path broken underneath reads ``correct``
  false, for each fault the cell can have: half of the batch left out, an
  answer altered where it is produced, and (corpus) a step that returns
  its state unchanged.  One card holds every cell, so no exchange between
  chips can be left out.

The control on the card at the cells' own sizes: ``benchmark/calibrate.py``.
"""

from __future__ import annotations

import pytest
import torch

from _cells import CORPUS, small  # noqa: E402
from benchkit import cell, compare, spec  # noqa: E402

DEVICE = [w["name"] for w in spec.benchmark()["workloads"] if "device" in w["traffic"]]


@pytest.mark.parametrize("workload", DEVICE + [CORPUS])
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_the_control_is_not_correct(workload, seed):
    # the speechpy control's worst frames are those whose DC bin cancels: a
    # few thousand frames hold some, as every cell's window does
    c = small(workload, rows=8, seconds=2.0)
    ctx = cell.Context(c, seed, torch.device("cpu"))
    drv = spec.driver(c.traffic["kind"]).Driver(ctx)
    drv.setup()
    drv.window(0.2)
    try:
        program = {k: v for k, v in drv.numbers("program").items() if not k.startswith("_")}
        control = {k: v for k, v in drv.numbers("control").items() if not k.startswith("_")}
    finally:
        drv.close()
    assert compare.judge(program, c.limits)[0], program
    assert not compare.judge(control, c.limits)[0], control


def _half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0  # the second half of the batch (of the rows) left out
    return out


def _altered(out):
    out = out.contiguous().clone()
    flat = out.view(-1)
    flat[flat.numel() // 3] += 0.05 * float(out.abs().max())  # one answer, 5% of the largest
    return out


FAULTS = {"half_batch": _half, "altered": _altered}


@pytest.mark.parametrize("workload", DEVICE)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_entry_point_is_not_correct(workload, fault, monkeypatch):
    from mfcc_rust_tpu_torch import features

    c = small(workload)
    name = {"mfcc": "mfcc", "mel_spectrogram_librosa": "mel_spectrogram_librosa"}[
        c.config["api"]["function"]]
    if fault:
        real = getattr(features, name)
        monkeypatch.setattr(features, name, lambda *a, **k: FAULTS[fault](real(*a, **k)))
    rec = cell.run(c, 2 ** 31 + 21, 0.2, False, "cpu")
    assert rec["correct"] is (fault is None), rec["compared"]


@pytest.mark.parametrize("fault", [None, "state_unchanged", *FAULTS])
def test_a_broken_corpus_step_is_not_correct(fault, monkeypatch):
    from mfcc_rust_tpu_torch.parallel import data
    from mfcc_rust_tpu_torch.parallel.stats import CorpusMoments

    real = data.extraction_step_packed

    def broken(*a, **k):
        feats, moments = real(*a, **k)
        if fault == "state_unchanged":
            return feats, CorpusMoments(*(torch.zeros_like(torch.as_tensor(t)) for t in moments))
        return FAULTS[fault](feats), moments

    if fault:
        monkeypatch.setattr(data, "extraction_step_packed", broken)
    rec = cell.run(small(CORPUS), 2 ** 31 + 22, 0.2, False, "cpu")
    assert rec["correct"] is (fault is None), rec["compared"]
