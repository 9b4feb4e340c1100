"""Mean ms a proof's host waits for the card in ``.cpu()`` of its five MSM
outputs, the port's span ``prove.fetch``, over the traced run's profiled
stretch (``zkbench.spans``)."""

from zkbench import spans


def read(run):
    return spans.per_proof(
        run, __file__, lambda j: spans.span_ms(j, "prove.fetch"))
