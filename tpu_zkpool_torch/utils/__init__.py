"""Host utilities: the metrics registry and span recorder (``metrics``),
and ``torch.profiler`` traces and launch counts (``profiling``). The JAX
package's compile caches (``utils/aot.py``, ``utils/compile_cache.py``)
have no counterpart: torch has no XLA executables to cache, and
``cuda_build`` caches the kernels' libraries by content hash."""

from tpu_zkpool_torch.utils.metrics import DEFAULT, Metrics
from tpu_zkpool_torch.utils.profiling import trace

__all__ = ["DEFAULT", "Metrics", "trace"]
