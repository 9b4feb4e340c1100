"""Device profiler traces and launch counts (SURVEY.md §5).

The port of ``tpu_zkpool/utils/profiling.py``'s device layer: ``trace()``
wraps a region in ``torch.profiler`` so kernel-level timelines land in a
Chrome trace file when TORCH_PROFILE_DIR is set, and ``kernel_launches()``
counts the kernels a call launches on the card. Stage timing is the
metrics registry's (``utils.metrics``: ``timer`` and ``span``).
"""

from __future__ import annotations

import contextlib
import os
import re

# The host's calls into the CUDA runtime and driver that launch one kernel
# each, and those that copy or fill device memory; the card's rows of the
# copies and fills.
LAUNCH_CALLS = re.compile(r"cu(da)?Launch(Cooperative)?Kernel")
COPY_CALLS = re.compile(r"cu(da)?Mem(cpy|set)")
COPY_ROWS = ("Memcpy", "Memset")


@contextlib.contextmanager
def trace(name: str = "tpu_zkpool_torch"):
    """Capture a torch.profiler trace of the region (the host and, where
    CUDA is present, the card) into ``$TORCH_PROFILE_DIR/<name>.json`` when
    TORCH_PROFILE_DIR is set (open it in Perfetto or chrome://tracing);
    no-op otherwise. The prover's spans (``utils.metrics.span``) are the
    trace's user annotations, so it names the prover's own phases."""
    out = os.environ.get("TORCH_PROFILE_DIR")
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"{name}.json"))


def split_launches(rows):
    """({launch call: count}, {kernel: records}, {copy or fill call:
    count}) of profiler rows, each with ``key``, ``count`` and
    ``device_type`` (``key_averages()``'s entries).

    A launch is counted at the host's call that makes it
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
    ...), not at the card's record of the kernel: torch.profiler loses
    some of the card's records, more the longer a process profiles, and
    keeps every host call (``scripts/launch_count_probe.py``). The card's
    records, the copies and fills left out, name the kernels; its rows of
    the prover's spans (``utils.metrics.span``, user annotations) are
    neither."""
    from torch.autograd import DeviceType

    launches, kernels, copies = {}, {}, {}
    for e in rows:
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            if e.key.startswith(COPY_ROWS):
                continue
            into = kernels
        elif LAUNCH_CALLS.match(e.key):
            into = launches
        elif COPY_CALLS.match(e.key):
            into = copies
        else:
            continue
        into[e.key] = into.get(e.key, 0) + e.count
    return launches, kernels, copies


def launch_line(one, two, n):
    """{name: base + n x step}, names at 0 left out: the count of each
    name over n steps of a loop whose op sequence does not depend on the
    data, from {name: count} over 1 step (``one``) and 2 (``two``)."""
    line = {k: 2 * one.get(k, 0) - two.get(k, 0)
            + n * (two.get(k, 0) - one.get(k, 0)) for k in one.keys() | two}
    return {k: v for k, v in line.items() if v}


def kernel_launches(fn):
    """(``fn()``'s output, {launch call: count}, {kernel: records}, {copy
    or fill call: count}) by torch.profiler over one call of ``fn``
    (``split_launches``), the card synchronized before it and inside the
    profile after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return (out,) + split_launches(prof.key_averages())
