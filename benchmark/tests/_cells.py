"""Cells at a size the CPU runs in a second, for the benchmark's tests."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from benchkit import spec  # noqa: E402

# the corpus cell, which BENCHMARK.json leaves out for now (PERF.md, Open
# questions): its driver, traffic and limits are kept and tested
CORPUS = "speechpy_mfcc13_16k.corpus_devclean2703"


def small(name: str, rows: int = 2, seconds: float = 0.5) -> spec.Cell:
    """The cell ``name``, its traffic cut to a CPU test's size."""
    c = spec.cell(name) if name != CORPUS else spec.make_cell(name, *name.split("."))
    if c.traffic["kind"] == "corpus":
        over = {"files": 12, "max_s": 4.0, "check_files": 200,
                "runner": {**c.traffic["runner"], "batch_size": 4}}
    else:
        over = {"rows": rows, "seconds_of_audio": seconds, "warm_cycles": 1,
                "pick_range": 20, "slice_calls": 20}
    return dataclasses.replace(c, traffic={**c.traffic, **over})
