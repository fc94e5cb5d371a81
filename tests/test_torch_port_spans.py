"""The port's spans and its bucket pad counter, on the CPU:
``mfcc_rust_tpu_torch.utils.profiling.span`` / ``spans`` / ``annotate``
and ``utils.bucketing.samples``.

The replayed call path runs through the ``replayed`` fixture of
``tests/test_torch_port_graphs.py`` (the real ``utils.graphs`` layer around
a stand-in graph), so a call records the spans it records on the card:
``api.<entry>`` around ``graphs.run``, and inside it ``graphs.capture`` at a
first call or ``graphs.fill``, ``graphs.replay`` and ``graphs.copy_out``."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.utils import bucketing
from mfcc_rust_tpu_torch.utils import profiling as prof
from mfcc_rust_tpu_torch.utils.bucketing import bucket_length
from tests.test_torch_port_graphs import replayed  # noqa: F401 - the fixture

REPLAYED = ("graphs.fill", "graphs.replay", "graphs.copy_out")

# (entry point, its arguments after the input, its keywords, the input's length)
CALLS = [
    ("mfcc", (16000,), {}, 15000),
    ("mel_spectrogram_librosa", (), {"sr": 16000, "n_fft": 512, "hop_length": 160}, 9000),
]


def _signal(rows, n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 0.1, (rows, n))
                            .astype(np.float32))


def _call(name, args, kw, x):
    return getattr(P, name)(x, *args, device="cpu", **kw)


def _children(records):
    kids = {id(r): [] for r in records}
    for r in records:
        if r.parent is not None:
            kids[id(r.parent)].append(r)
    return kids


def _tree(record, kids):
    return (record.name, sorted(_tree(k, kids) for k in kids[id(record)]))


# ------------------------------------------------------- one call's spans --
@pytest.mark.parametrize("name,args,kw,n", CALLS, ids=[c[0] for c in CALLS])
def test_a_replayed_call_records_one_tree_under_one_id(replayed, name, args, kw, n):
    x = _signal(2, n)
    _call(name, args, kw, x)  # the capture
    with prof.spans() as rec:
        _call(name, args, kw, x)
    records = rec.records
    assert rec.dropped == 0 and len({r.call for r in records}) == 1
    roots = [r for r in records if r.parent is None]
    assert len(roots) == 1 and roots[0] is records[0]
    name0, call0, parent0, t0, t1, thread0 = roots[0]
    assert (name0, call0, parent0, thread0) == (f"api.{name}", records[1].call, None,
                                                records[1].thread) and t0 < t1
    want = (f"api.{name}", [("graphs.run", sorted((s, []) for s in REPLAYED))])
    assert _tree(roots[0], _children(records)) == want
    assert all(r.t1_ns is not None and r.thread == threading.get_ident() for r in records)
    fill, replay, copy_out = (next(r for r in records if r.name == s) for s in REPLAYED)
    assert fill.t1_ns <= replay.t0_ns and replay.t1_ns <= copy_out.t0_ns
    assert replayed.captures == 1 and replayed.replays == 1


def test_a_first_call_records_its_capture_and_no_replay(replayed):
    with prof.spans() as rec:
        _call("mfcc", (16000,), {}, _signal(2, 15000))
    names = [r.name for r in rec.records]
    assert names == ["api.mfcc", "graphs.run", "graphs.capture"]
    assert rec.records[2].parent is rec.records[1] and replayed.captures == 1


@pytest.mark.parametrize("name,args,kw,n", CALLS, ids=[c[0] for c in CALLS])
def test_self_times_of_a_call_sum_to_its_outermost_span(replayed, name, args, kw, n):
    x = _signal(2, n)
    _call(name, args, kw, x)
    with prof.spans() as rec:
        for _ in range(3):
            _call(name, args, kw, x)
    by_call = {}
    for r in rec.records:
        by_call.setdefault(r.call, []).append(r)
    assert len(by_call) == 3
    for records in by_call.values():
        kids = _children(records)
        for r in records:  # every child inside its parent, the children apart
            inner = sorted((k.t0_ns, k.t1_ns) for k in kids[id(r)])
            assert all(r.t0_ns <= a <= b <= r.t1_ns for a, b in inner)
            assert all(b0 <= a1 for (_, b0), (a1, _) in zip(inner, inner[1:]))
        self_ns = [(r.t1_ns - r.t0_ns) - sum(k.t1_ns - k.t0_ns for k in kids[id(r)])
                   for r in records]
        root = records[0]
        assert root.parent is None and sum(self_ns) == root.t1_ns - root.t0_ns
        assert min(self_ns) >= 0


def test_two_threads_calls_get_their_own_ids(replayed):
    x = _signal(2, 15000)
    _call("mfcc", (16000,), {}, x)
    start, errors = threading.Barrier(2), []

    def work():
        try:
            start.wait(timeout=30)
            for _ in range(5):
                _call("mfcc", (16000,), {}, x)
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(e))

    with prof.spans() as rec:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []
    idents = {t.ident for t in threads}
    calls = {}
    for r in rec.records:
        calls.setdefault(r.call, set()).add(r.thread)
        assert r.parent is None or (r.parent.thread == r.thread and r.parent.call == r.call)
    assert len(calls) == 10 and all(len(t) == 1 for t in calls.values())
    assert {next(iter(t)) for t in calls.values()} == idents
    assert len(rec.records) == 10 * 5


def test_spans_nest_per_thread_under_contention():
    """Sixteen threads nesting spans, switching every microsecond: each
    span's parent is its own thread's enclosing span, and the recorder
    keeps or counts every span begun."""
    depth, calls, errors = 3, 40, []

    def work():
        try:
            for _ in range(calls):
                with prof.span("a"):
                    with prof.span("b"):
                        with prof.span("c"):
                            pass
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with prof.spans(limit=1000) as rec:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(rec.records) == 1000 and rec.dropped == 16 * calls * depth - 1000
    for r in rec.records:
        want = {"a": None, "b": "a", "c": "b"}[r.name]
        assert (r.parent.name if r.parent is not None else None) == want
        assert r.parent is None or (r.parent.thread, r.parent.call) == (r.thread, r.call)
    roots = [r.call for r in rec.records if r.parent is None]
    assert len(roots) == len(set(roots))


# ----------------------------------------------------------- off is off --
def test_off_means_the_idle_span_and_no_profiler_scope(replayed, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with nothing recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    idle = prof.span("graphs.fill")
    assert idle is prof.span("graphs.fill") and type(idle).__name__ == "_Idle"
    assert not prof.recording()
    with idle as entered:
        assert entered is idle
    x = _signal(2, 15000)
    _call("mfcc", (16000,), {}, x)
    _call("mfcc", (16000,), {}, x)  # a replay: every span of the path, idle
    assert getattr(prof._local, "top", None) is None
    blocks = sys.getallocatedblocks()
    for _ in range(2000):
        with prof.span("graphs.fill"):
            pass
    assert sys.getallocatedblocks() - blocks < 50


def test_an_exception_leaves_the_span_closed():
    with prof.spans() as rec:
        with pytest.raises(ValueError):
            with prof.span("outer"):
                with prof.span("inner"):
                    raise ValueError("in the span")
        with prof.span("after"):
            pass
    outer, inner, after = rec.records
    assert inner.parent is outer and after.parent is None and after.call != outer.call
    assert all(r.t1_ns is not None for r in rec.records)


def test_the_buffer_counts_what_it_drops():
    with prof.spans(limit=3) as rec:
        for _ in range(5):
            with prof.span("s"):
                pass
    assert [r.name for r in rec.records] == ["s"] * 3 and rec.dropped == 2
    assert prof._recorder is None


# ---------------------------------------------------- the profiler bridge --
def test_spans_and_annotations_nest_in_the_profiler_trace(replayed, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    @prof.annotate("decorated")
    def decorated(x):
        return _call("mfcc", (16000,), {}, x)

    x = _signal(2, 15000)
    _call("mfcc", (16000,), {}, x)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.annotate("user"):
            decorated(x)
    path = tmp_path / "t.json"
    p.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    spans = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events}
    chain = ["user", "decorated", "api.mfcc", "graphs.run"]
    assert set(chain + list(REPLAYED)) <= set(spans)
    for outer, inner in zip(chain, chain[1:]):
        assert spans[outer][0] <= spans[inner][0] and spans[inner][1] <= spans[outer][1]
    for s in REPLAYED:
        assert spans["graphs.run"][0] <= spans[s][0] and spans[s][1] <= spans["graphs.run"][1]


def test_annotate_records_as_a_decorator_and_as_a_context():
    @prof.annotate("decorated")
    def twice(v):
        return 2 * v

    assert twice.__name__ == "twice"
    with prof.spans() as rec:
        with prof.annotate("block"):
            assert twice(3) == 6
    assert [(r.name, r.parent.name if r.parent else None) for r in rec.records] == \
        [("block", None), ("decorated", "block")]


def test_entry_points_keep_their_signatures():
    import inspect

    import mfcc_rust_tpu.api as japi

    for name in ("mfcc", "mfe", "lmfe", "ssc", "extract", "mel_spectrogram",
                 "mel_spectrogram_librosa", "log_mel_spectrogram", "mfcc_librosa"):
        ours = inspect.signature(getattr(P, name)).parameters
        ref = inspect.signature(getattr(japi, name)).parameters
        assert list(ours)[:len(ref)] == list(ref), name
        assert getattr(P, name).__name__ == name


# ------------------------------------------------------ the pad counter --
# (entry point, keywords, rows, true length a row): the three benchmark
# cells' configurations and lengths (48, 32 and 64 rows there)
CELLS = [
    ("mfcc", {"sampling_frequency": 16000}, 160_000, 160_000),
    ("mel_spectrogram_librosa", {"sr": 22050}, 220_500, 220_500 + 2048),
    ("mel_spectrogram_librosa", {"sr": 16000, "n_fft": 512, "hop_length": 160, "n_mels": 80},
     160_000, 160_000 + 512),
]


@pytest.mark.parametrize("name,kw,n,true", CELLS, ids=["speechpy", "librosa128", "librosa80"])
def test_pad_counter_counts_true_and_bucketed_samples(monkeypatch, name, kw, n, true):
    monkeypatch.setattr(bucketing, "samples", bucketing.SampleCount())
    getattr(P, name)(_signal(2, n), device="cpu", **kw)
    assert bucketing.samples.read() == (2 * true, 2 * bucket_length(true))


def test_pad_shares_of_the_cells_shapes():
    shares = [round(1 - t / bucket_length(t), 4) for _, _, _, t in CELLS]
    assert shares == [0.0994, 0.1984, 0.0965]


def test_pad_counter_counts_replayed_and_unbucketed_calls(replayed, monkeypatch):
    monkeypatch.setattr(bucketing, "samples", bucketing.SampleCount())
    x = _signal(3, 9000)
    for _ in range(2):  # the capture, then a replay
        _call("mfcc", (16000,), {}, x)
        _call("mel_spectrogram_librosa", (), {"sr": 16000, "n_fft": 512}, x)
    _call("mel_spectrogram_librosa", (), {"center": False, "bucket": False}, x)
    _call("mfcc", (16000,), {}, x[0])
    want_true = 2 * (3 * 9000 + 3 * 9512) + 3 * 9000 + 9000
    want_bucketed = (2 * (3 * bucket_length(9000) + 3 * bucket_length(9512)) + 3 * 9000
                     + bucket_length(9000))
    assert bucketing.samples.read() == (want_true, want_bucketed)
    assert replayed.replays == 2
