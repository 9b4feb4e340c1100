"""Structured metrics registry (SURVEY.md §5 observability) and the port's
spans: the port's copy of ``tpu_zkpool/utils/metrics.py``, with its own
process-wide ``DEFAULT``.

The reference logs breadcrumbs (on-chain ``log()`` strings, relayer
console lines) with no aggregation; this registry gives the framework a
single place to count events and record timing distributions, exportable
as one JSON object — the library-level analogue of the relayer health
endpoint plus the reference's per-stage timing tables.

``span(name)`` names a phase of the prover at its layer boundaries. While
a ``torch.profiler`` profile runs it is ``record_function(name)``, so the
profile's trace shows the phase as a user annotation on the thread that
ran it, nested in the spans open there; the trace holds its times, and
the device work it launched through kineto's correlation ids. Without a
profile ``span()`` returns one shared null context after one flag check:
no lock, no clock read, no allocation, and nothing is kept.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict

# ``_tprof._is_profiler_enabled`` is the module flag a torch.profiler
# profile sets while it runs.
import torch.autograd.profiler as _tprof


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        return None


NULL_SPAN = _Null()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profile runs,
    else ``NULL_SPAN``."""
    if _tprof._is_profiler_enabled:
        return _tprof.record_function(name)
    return NULL_SPAN


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
        """Observe the seconds of a block (monotonic clock) under ``name``,
        which is also the block's span."""
        metrics = self

        class _T:
            def __enter__(self):
                self.span = span(name)
                self.span.__enter__()
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metrics.observe(name, time.perf_counter() - self.t0)
                self.span.__exit__(*exc)
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
