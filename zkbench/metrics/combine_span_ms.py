"""Mean ms of a proof's host combine, the port's span ``prove.combine``
(``_finish_proof``), over the traced run's profiled stretch, where nothing
synchronises the device between phases (``zkbench.spans``)."""

from zkbench import spans


def read(run):
    return spans.per_proof(
        run, __file__, lambda j: spans.span_ms(j, "prove.combine"))
