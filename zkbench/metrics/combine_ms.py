"""Mean ms of a proof's host combine (``prove(timings=)["combine"]``: the
fetch of the five MSMs' outputs and ``_finish_proof``), in the traced
run's second half."""

import statistics


def read(run):
    vals = [t["combine"] for t in run.timings if "combine" in t]
    return statistics.fmean(vals) * 1e3 if vals else None
