"""Per-stage timing and optional device profiler traces (SURVEY.md §5).

The port of ``tpu_zkpool/utils/profiling.py``. The reference times every
pipeline stage with shell/`time.time()` wrappers and prints a summary table
(``prove_linux.sh:21-25``, ``generate_audit.py:644-716``); this module keeps
that UX (a ``StageTimer`` context collecting (stage, seconds) rows and
printing the same kind of table) and adds the device layer: ``trace()``
wraps a region in ``torch.profiler`` so kernel-level timelines land in a
Chrome trace file when TORCH_PROFILE_DIR is set.
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    """Collects named stage timings; prints a generate_audit.py-style
    summary table."""

    def __init__(self, title: str = "pipeline"):
        self.title = title
        self.rows: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = True):
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.rows.append((name, dt))
        if verbose:
            print(f"[{self.title}] {name}: {dt:.2f}s", flush=True)

    def summary(self) -> str:
        width = max((len(n) for n, _ in self.rows), default=10)
        total = sum(t for _, t in self.rows)
        lines = ["=" * (width + 14),
                 f"{self.title} timing summary",
                 "-" * (width + 14)]
        for name, t in self.rows:
            lines.append(f"{name:<{width}}  {t:>9.2f}s")
        lines.append("-" * (width + 14))
        lines.append(f"{'TOTAL':<{width}}  {total:>9.2f}s")
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary(), flush=True)


@contextlib.contextmanager
def trace(name: str = "tpu_zkpool_torch"):
    """Capture a torch.profiler trace of the region (the host and, where
    CUDA is present, the card) into ``$TORCH_PROFILE_DIR/<name>.json`` when
    TORCH_PROFILE_DIR is set (open it in Perfetto or chrome://tracing);
    no-op otherwise."""
    out = os.environ.get("TORCH_PROFILE_DIR")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"{name}.json"))
