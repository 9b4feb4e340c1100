"""Mean host launch calls a proof (``utils.profiling.LAUNCH_CALLS`` in the
profiler's trace, the hand-written kernels and torch's alike) under the
port's root spans ``prove.proof`` and ``prove.batch``, over the traced
run's profiled stretch (``zkbench.spans``). Nothing without a card."""

from zkbench import spans


def read(run):
    return spans.per_proof(run, __file__, lambda j: j.get("launches"))
