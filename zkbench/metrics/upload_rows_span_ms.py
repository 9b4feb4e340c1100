"""Mean ms a proof spends packing its witness, uploading its scalars and
evaluating and uploading its U, V, W rows: the port's spans
``prove.pack_witness``, ``prove.upload`` and ``prove.h_rows``, over the
traced run's profiled stretch (``zkbench.spans``)."""

from zkbench import spans


def read(run):
    return spans.per_proof(run, __file__, lambda j: spans.span_ms(
        j, "prove.pack_witness", "prove.upload", "prove.h_rows"))
