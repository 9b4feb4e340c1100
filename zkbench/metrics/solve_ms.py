"""Mean ms of a request's witness solve (``solver_native.solve`` and
``r1cs.build_witness``), the benchmark's own span around the calls, in the
traced run's second half."""

import statistics


def read(run):
    spans = run.spans.get("solve")
    return statistics.fmean(spans) * 1e3 if spans else None
