"""Mean ms a proof keeps the card busy with H(X): the union of the device
intervals of what the port launched inside its span ``prove.h_ntt`` and
outside ``prove.h_rows`` (the transforms, not the rows' upload), over the
traced run's profiled stretch (``zkbench.spans``). Nothing without a
card."""

from zkbench import spans


def read(run):
    return spans.per_proof(run, __file__, lambda j: (
        j["busy_s"]["hx"] * 1e3 if "busy_s" in j else None))
