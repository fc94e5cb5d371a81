"""Host-clock metering for the corpus runner.

:class:`Meter` accumulates named wall-clock scopes with audio-seconds
throughput accounting, free-form counters (transfer bytes, dispatch and
fetch counts) and per-call spans whose union gives the time a kind of call
kept busy, overlapping calls counted once.  Device time is not here: the
host clock around an asynchronous CUDA call measures its enqueue, so device
times come from CUDA events (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class Meter:
    """Accumulating throughput meter: audio-seconds per wall second, plus
    free-form counters (transfer bytes, fetch/dispatch counts)."""

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    batches: int = 0
    scopes: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    # per-call wall-clock spans [(name, t0, t1)]; list.append is atomic
    # under the GIL, so pool threads record theirs too
    spans: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, audio_seconds: float, scope: str = "extract"):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.audio_seconds += audio_seconds
        self.wall_seconds += dt
        self.batches += 1
        self.scopes[scope] = self.scopes.get(scope, 0.0) + dt

    @contextlib.contextmanager
    def span(self, name: str):
        """Record a named wall-clock interval (absolute perf_counter times).
        Unlike :meth:`measure`, spans keep per-call start/end so overlap and
        busy unions are computable afterwards."""
        t0 = time.perf_counter()
        yield
        self.spans.append((name, t0, time.perf_counter()))

    def span_union(self, *names: str) -> float:
        """Total seconds covered by the union of the named spans (merged
        intervals — concurrent calls do not double-count)."""
        want = set(names)
        ivs = sorted((t0, t1) for n, t0, t1 in self.spans if n in want)
        total, cur1 = 0.0, None
        cur0 = None
        for a, b in ivs:
            if cur1 is None or a > cur1:
                if cur1 is not None:
                    total += cur1 - cur0
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        if cur1 is not None:
            total += cur1 - cur0
        return total

    def bump(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @property
    def throughput(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def report(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "audio_seconds_per_sec": round(self.throughput, 1),
            "batches": self.batches,
            "scopes": {k: round(v, 4) for k, v in self.scopes.items()},
            "counters": {k: round(v, 1) for k, v in self.counters.items()},
        }

    def __str__(self) -> str:
        return json.dumps(self.report())
