"""Per-chunk runtime telemetry (counterpart of ``repro.stream.telemetry``).

Every ingested chunk produces one ChunkMetrics record: pool occupancy,
creations, the lifecycle's prunes, merges and spawns (folded into the
record of the chunk that ended before the pass), dispatch path and wall
time.  ``Telemetry`` keeps a bounded history and running totals.  The
anomaly detector bridge waits for the port of ``ft/anomaly.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class ChunkMetrics:
    idx: int
    n_points: int
    active_k: int
    created: int = 0
    pruned: int = 0
    merged: int = 0
    spawned: int = 0
    path: str = "scan"
    latency_s: float = 0.0

    @property
    def points_per_s(self) -> float:
        # latency_s == 0 means the timer under-resolved: NaN, not inf or 0
        if self.latency_s > 0:
            return self.n_points / self.latency_s
        return float("nan")


class Telemetry:
    """Bounded metric history + running counters (exact for unbounded
    streams; ``history`` is an inspection window only)."""

    _COUNTERS = ("created", "pruned", "merged", "spawned")

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self.history: List[ChunkMetrics] = []
        self.total_points = 0
        self.total_time_s = 0.0
        self.total_chunks = 0
        self.totals: Dict[str, int] = {k: 0 for k in self._COUNTERS}
        # vmem-path accept counter: accumulated on the device by the
        # runtime and folded in here at lifecycle boundaries and at the end
        # of each ``ingest`` call
        self.total_accepted = 0
        # rows the non-finite guard quarantined (never ingested)
        self.total_quarantined = 0

    def record(self, m: ChunkMetrics) -> None:
        self.history.append(m)
        if len(self.history) > self.capacity:
            self.history = self.history[-self.capacity:]
        self.total_points += m.n_points
        self.total_time_s += m.latency_s
        self.total_chunks += 1
        for k in self._COUNTERS:
            self.totals[k] += getattr(m, k)

    def add_quarantined(self, n: int) -> None:
        self.total_quarantined += int(n)

    def add_accepted(self, n: int) -> None:
        self.total_accepted += int(n)

    def add_lifecycle(self, pruned: int, merged: int, spawned: int) -> None:
        """Fold a lifecycle pass into the totals and the last record."""
        self.totals["pruned"] += pruned
        self.totals["merged"] += merged
        self.totals["spawned"] += spawned
        if self.history:
            last = self.history[-1]
            last.pruned += pruned
            last.merged += merged
            last.spawned += spawned

    def summary(self) -> Dict[str, object]:
        last = self.history[-1] if self.history else None
        return {
            "chunks": self.total_chunks,
            "total_points": self.total_points,
            "points_per_s": (self.total_points / self.total_time_s
                             if self.total_time_s > 0 else float("nan")),
            "active_k": last.active_k if last else 0,
            **self.totals,
            "accepted": self.total_accepted,
            "quarantined": self.total_quarantined,
        }
