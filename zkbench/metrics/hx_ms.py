"""Mean ms of a proof's H(X) on the device, the ``h_ntt`` phase less its
row evaluations (``timings["h_ntt"] - timings["h_rows"]``), in the traced
run's second half."""

import statistics


def read(run):
    vals = [t["h_ntt"] - t["h_rows"] for t in run.timings
            if "h_ntt" in t and "h_rows" in t]
    return statistics.fmean(vals) * 1e3 if vals else None
