"""Structured metrics registry (SURVEY.md §5 observability): the port's copy
of ``tpu_zkpool/utils/metrics.py``, with its own process-wide ``DEFAULT``.

The reference logs breadcrumbs (on-chain ``log()`` strings, relayer
console lines) with no aggregation; this registry gives the framework a
single place to count events and record timing distributions, exportable
as one JSON object — the library-level analogue of the relayer health
endpoint plus the reference's per-stage timing tables.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = defaultdict(int)
        self._timings = defaultdict(list)

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._timings[name].append(seconds)

    def timer(self, name: str):
        metrics = self

        class _T:
            def __enter__(self):
                self.t0 = time.time()
                return self

            def __exit__(self, *exc):
                metrics.observe(name, time.time() - self.t0)
                return False

        return _T()

    def snapshot(self) -> dict:
        with self._lock:
            timings = {
                k: {
                    "count": len(v),
                    "total_s": round(sum(v), 4),
                    "mean_s": round(sum(v) / len(v), 4),
                    "max_s": round(max(v), 4),
                }
                for k, v in self._timings.items() if v
            }
            return {"counters": dict(self._counters), "timings": timings}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timings.clear()


DEFAULT = Metrics()
