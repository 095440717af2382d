"""Structured per-epoch/per-step metrics (JSONL) + simple timers.

The reference's observability is stdout prints every 5 epochs plus two text
manifests (model.py:348-360). Those are preserved elsewhere; this module adds
the structured record the reference lacks: one JSON line per epoch with
losses, lr, throughput, and wall time, machine-readable for dashboards.

The port's own copy of ai_font_renderer_tpu/utils/metrics.py, code unchanged.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, path: str | None, resume: bool = False):
        self.path = path
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            if not resume:
                # truncate any previous run's log; resumed runs append so
                # the prior epochs' history survives (operators poll this
                # file on long runs — see CLAUDE.md).
                open(path, "w").close()

    def log(self, **record) -> None:
        if not self.path:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class Stopwatch:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
