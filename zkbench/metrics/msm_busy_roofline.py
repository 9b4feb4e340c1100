"""The five MSMs' share of their roofline on the card's own time, %: the
least time of a proof's five MSMs (``zkbench.work``, as ``msm_roofline``)
over the mean device busy time a proof of what the port launched inside
its ``msm.*`` spans (the union of those kernels', copies' and fills'
intervals), over the traced run's profiled stretch (``zkbench.spans``).
None if any launch under those spans has no device record, so a lost
record cannot raise it; nothing for a card without peaks."""

from zkbench import spans, work


def read(run):
    peak = work.peaks(run.card) if run.card else None
    busy = spans.per_proof(run, __file__, lambda j: (
        j.get("busy_s", {}).get("msm")))
    if not peak or not busy or not run.msm_points:
        return None
    least = sum(work.least_seconds(n, g, peak)[0]
                for g, ns in run.msm_points.items() for n in ns)
    return 100.0 * least / busy
