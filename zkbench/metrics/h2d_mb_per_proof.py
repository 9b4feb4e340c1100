"""Mean MB (10^6 bytes) a proof copies from the host to the card: the
bytes of the trace's host-to-device copies made under the port's root
spans ``prove.proof`` and ``prove.batch``, over the traced run's profiled
stretch (``zkbench.spans``). Nothing without a card."""

from zkbench import spans


def read(run):
    return spans.per_proof(run, __file__, lambda j: (
        j["h2d_bytes"] / 1e6 if "h2d_bytes" in j else None))
