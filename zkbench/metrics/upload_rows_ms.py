"""Mean ms a proof spends packing and uploading its witness and
evaluating its U, V, W rows (``timings["upload"] + timings["h_rows"]``),
in the traced run's second half."""

import statistics


def read(run):
    vals = [t["upload"] + t["h_rows"] for t in run.timings
            if "upload" in t and "h_rows" in t]
    return statistics.fmean(vals) * 1e3 if vals else None
