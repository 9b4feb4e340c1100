"""Mean blocking calls a proof (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` in the profiler's
trace: a pageable upload's and a fetch's waits among them) under the
port's root spans, over the traced run's profiled stretch
(``zkbench.spans``). Nothing without a card."""

from zkbench import spans


def read(run):
    return spans.per_proof(run, __file__, lambda j: j.get("syncs"))
