"""The five MSMs' share of their roofline, %: the least time of a proof's
five MSMs (``zkbench.work``: the products of a signed-digit Pippenger at
its best window over the card's 32-bit multiply-add peak, or the bytes
over its memory bandwidth, whichever is larger) over the mean of the sum
of the ``msm_*`` phases of a proof, in the traced run's second half.
Nothing for a card without peaks in ``zkbench/peaks.json``."""

import statistics

from zkbench import work

PHASES = ("msm_a", "msm_b1", "msm_b2", "msm_h", "msm_k")


def read(run):
    peak = work.peaks(run.card) if run.card else None
    sums = [sum(t[p] for p in PHASES) for t in run.timings
            if all(p in t for p in PHASES)]
    if not peak or not sums or not run.msm_points:
        return None
    least = sum(work.least_seconds(n, g, peak)[0]
                for g, ns in run.msm_points.items() for n in ns)
    return 100.0 * least / statistics.fmean(sums)
