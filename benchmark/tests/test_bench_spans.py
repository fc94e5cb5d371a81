"""CPU tests of the readers of the program's spans and pad counter
(``benchkit/spans.py``, ``metrics/api.*``, ``graphs.*``,
``bucketing.pad_share`` and their ``.host_paced`` twins): the self-time
arithmetic on records made by hand, the burst's refusals, and the twins.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest
import torch

from _cells import small  # noqa: E402
from benchkit import cell, spans, spec  # noqa: E402

SPEECHPY = "speechpy_mfcc13_16k.device_b48x10s"
BASES = ["api.entry_self_us", "graphs.run_self_us", "graphs.fill_us", "graphs.replay_us",
         "graphs.copy_out_us", "bucketing.pad_share"]


class Rec:
    """A record as the program's recorder makes one."""

    def __init__(self, name, call, parent, t0, t1):
        self.name, self.call, self.parent, self.t0_ns, self.t1_ns = name, call, parent, t0, t1


def _call(call, t, run=(10, 90), fill=(20, 30), replay=(30, 70), copy=(75, 85), end=100):
    root = Rec("api.mfcc", call, None, t, t + end)
    g = Rec("graphs.run", call, root, t + run[0], t + run[1])
    kids = [Rec(n, call, g, t + a, t + b) for n, (a, b) in
            (("graphs.fill", fill), ("graphs.replay", replay), ("graphs.copy_out", copy))]
    return [root, g, *kids]


def test_self_time_is_the_duration_less_what_the_children_cover():
    got = spans.self_times(_call(1, 1000))
    assert got == {1: {"api.mfcc": 20, "graphs.run": 20, "graphs.fill": 10,
                       "graphs.replay": 40, "graphs.copy_out": 10}}
    assert sum(got[1].values()) == 100


def test_overlapping_children_count_once_and_only_inside_the_parent():
    parent = Rec("p", 1, None, 0, 100)
    kids = [Rec("a", 1, parent, 10, 40), Rec("b", 1, parent, 30, 50),  # overlap 30-40
            Rec("c", 1, parent, 90, 130),  # runs past the parent's end
            Rec("d", 1, parent, 60, 60)]
    got = spans.self_times([parent, *kids])[1]
    assert got["p"] == 100 - (40 + 10)  # 10-50 and 90-100 covered
    assert (got["a"], got["b"], got["c"], got["d"]) == (30, 20, 40, 0)


def test_a_call_with_a_span_left_open_is_left_out():
    done = _call(1, 0)
    cut = _call(2, 200)
    cut[3].t1_ns = None  # its fill never closed
    assert set(spans.self_times(done + cut)) == {1}


def test_medians_over_the_calls():
    records = _call(1, 0) + _call(2, 200, replay=(30, 80)) + _call(3, 400, replay=(30, 60))
    got = spans.medians_us(records)
    assert got["graphs.replay"] == pytest.approx(40e-3)
    assert got["graphs.run"] == pytest.approx(20e-3) and got["api.mfcc"] == pytest.approx(20e-3)


def test_a_name_twice_in_a_call_sums():
    root = Rec("api.mfcc", 1, None, 0, 100)
    records = [root, Rec("x", 1, root, 0, 10), Rec("x", 1, root, 20, 25)]
    assert spans.self_times(records)[1] == {"api.mfcc": 85, "x": 15}


# ---------------------------------------------------------- the burst --
def _ctx():
    return cell.Context(small(SPEECHPY), 2 ** 40 + 7, torch.device("cpu"))


def test_the_burst_reads_the_entry_span_on_the_cpu():
    """On the CPU the entry runs eagerly: its span, and no graphs.* span."""
    ctx = _ctx()
    got = spans.numbers(ctx)
    assert got["calls"] == 20 and got["wall_us"] > 0 and set(got["self_us"]) == {"api.mfcc"}
    assert spec.metric("api.entry_self_us").read(ctx) == got["self_us"]["api.mfcc"] > 0
    assert spec.metric("graphs.replay_us").read(ctx) is None
    assert spans.numbers(ctx) is got  # measured once a run


def test_the_burst_reads_none_where_it_captured(monkeypatch):
    from mfcc_rust_tpu_torch.utils import graphs

    ctx = _ctx()
    entry = ctx.entry()

    def capturing(x):
        graphs.cache.captures += 1
        return entry(x)

    monkeypatch.setattr(graphs.cache, "captures", graphs.cache.captures)
    monkeypatch.setattr(ctx, "entry", lambda: capturing)
    assert spans.numbers(ctx) is None and spec.metric("api.entry_self_us").read(ctx) is None


def test_the_burst_reads_none_where_nothing_recorded(monkeypatch):
    ctx = _ctx()
    monkeypatch.setattr(ctx, "entry", lambda: (lambda x: x))
    assert spans.numbers(ctx) is None


def test_the_readers_read_none_from_a_program_without_spans_or_counter(monkeypatch):
    from mfcc_rust_tpu_torch.utils import bucketing, profiling

    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(bucketing, "samples")
    ctx = _ctx()
    for name in BASES:
        assert spec.metric(name).read(ctx) is None, name


def test_pad_share_reads_the_counter(monkeypatch):
    from mfcc_rust_tpu_torch.utils import bucketing

    count = bucketing.SampleCount()
    monkeypatch.setattr(bucketing, "samples", count)
    read = spec.metric("bucketing.pad_share").read
    assert read(None) is None
    count.add(48, 160_000, 177_664)
    assert round(read(None), 4) == 0.0994


@pytest.mark.parametrize("name", BASES)
def test_each_twin_reads_its_base(monkeypatch, name):
    from mfcc_rust_tpu_torch.utils import bucketing

    count = bucketing.SampleCount()
    count.add(32, 222_548, 277_632)
    monkeypatch.setattr(bucketing, "samples", count)
    ctx = _ctx()
    setattr(ctx, spans.ATTR, {"calls": 3, "wall_us": 9.0,
                              "self_us": {"api.mfcc": 1.5, "graphs.run": 2.5, "graphs.fill": 3.5,
                                          "graphs.replay": 4.5, "graphs.copy_out": 5.5}})
    base = spec.metric(name).read(ctx)
    assert base is not None and spec.metric(name + ".host_paced").read(ctx) == base
