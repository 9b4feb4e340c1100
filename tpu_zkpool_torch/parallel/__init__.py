"""Sharded paths over a device mesh (``mesh.Mesh``), in one process or
across the processes of a ``torch.distributed`` runtime.

- ``mesh``: named axes over shard slots, each with a device and (CUDA) a
  compute and a copy stream, and its owning process; shard / unshard,
  ``all_gather`` and ``ppermute`` (across processes where a group or a
  pair spans them).
- ``ntt_sharded``: the coefficient-axis-sharded negacyclic NTT, whose
  cross-shard stages run kernel K9 (``ntt_rdma``; across processes it
  reads the partner's shard by CUDA IPC).
- ``msm_sharded``: point-axis-sharded Pippenger, window sums per slot, one
  gather and a K4 fold, one Horner combine; ``prove_stages``: the four G1
  legs on a (leg, pt) mesh; ``multihost``: ``initialize`` (the
  multi-process runtime), ``pod_mesh`` (its host axis the process
  boundary), ``span_mesh`` (one axis over the processes) and the (host,
  chip) fold.
- ``merkle_sharded``: subtrees per slot through K7, one root combine.
"""

from tpu_zkpool_torch.parallel.mesh import Mesh  # noqa: F401
from tpu_zkpool_torch.parallel.ntt_sharded import (  # noqa: F401
    forward_sharded, inverse_sharded, negacyclic_mul_sharded,
)
from tpu_zkpool_torch.parallel.msm_sharded import msm_grid_sharded  # noqa: F401
from tpu_zkpool_torch.parallel.multihost import (  # noqa: F401
    initialize, pod_mesh, process_count, process_index, span_mesh,
)
