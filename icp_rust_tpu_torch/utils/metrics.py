"""Structured per-frame metrics and JSONL emission (JAX package
``utils/metrics.py``; plain Python, this package's own copy).

The reference has no observability at all (one eprintln; README notes even
println needs --features std).  The engine emits one record per aligned
frame: iteration counts, final robust error, inlier fraction, mean NN
distance, timing.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import IO, Optional


@dataclass
class FrameMetrics:
    frame: int
    seconds: float
    huber_error: float = float("nan")
    mean_nn_dist: float = float("nan")
    inlier_fraction: float = float("nan")
    delta_norm: float = float("nan")
    extra: dict = field(default_factory=dict)


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock helpers."""

    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO] = open(path, "a") if path else None
        self.records = []
        self._t0 = None

    def start_frame(self):
        self._t0 = time.perf_counter()

    def end_frame(self, frame: int, seconds: Optional[float] = None,
                  **kwargs) -> FrameMetrics:
        """``seconds`` overrides the start_frame() wall clock: segmented
        runners that time a segment of frames report each frame's share."""
        dt = seconds if seconds is not None else (
            time.perf_counter() - (self._t0 or time.perf_counter())
        )
        rec = FrameMetrics(frame=frame, seconds=dt, **kwargs)
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(asdict(rec)) + "\n")
            self._fh.flush()
        return rec

    def summary(self) -> dict:
        if not self.records:
            return {}
        secs = [r.seconds for r in self.records]
        return {
            "frames": len(self.records),
            "mean_seconds": sum(secs) / len(secs),
            "frames_per_s": len(secs) / sum(secs) if sum(secs) else 0.0,
        }

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
