#!/usr/bin/env python3
"""Try CUDA IPC between two processes on one card, once, and print what
CUDA says.

    python3 scripts/pod_ipc_probe.py        # on a machine with a CUDA card

K9 reads a partner shard that another process owns through a CUDA IPC
mapping of its block (``parallel/ntt_rdma.py``). This probe runs that
mapping alone: two worker processes of this script on cuda:0, joined over
Gloo (``multihost.initialize``). Each writes one caching-allocator tensor
(4,096 int32 words, rank r's word i = 1000 (r + 1) + i, placed after
another allocation so that it sits at a nonzero offset in its block),
records one interprocess event after the write, and exports both: the
tensor's block handle and offset by ``ntt_rdma.ipc_export`` (beside the
offset torch's own export reports, where it reports one) and the event's
handle. Each then maps the other's tensor (``ntt_rdma.ipc_open``), makes
its stream wait on the other's event, and reads the tensor through K9
(forward u side on a zero shard: out = the partner's words), and compares
the words with the pattern. Each rank prints one "IPC" JSON line: the
offsets, the words read and whether they match, or CUDA's error. The
script exits 0 once both workers have reported, whatever CUDA said, and
non-zero if a worker hangs or crashes without a report.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

TIMEOUT_S = 120
WORDS = 4096


def worker(rank: int, port: str) -> int:
    import torch
    from tpu_zkpool_torch.parallel import initialize, ntt_rdma
    dev = torch.device("cuda", 0)
    out = dict(rank=rank, cuda=torch.version.cuda)
    initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
               backend="gloo",
               timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
    pad = torch.zeros(1000, dtype=torch.int32, device=dev)
    x = torch.arange(WORDS, dtype=torch.int32, device=dev) + 1000 * (rank + 1)
    ev = torch.cuda.Event(interprocess=True)
    ev.record()
    mine = dict(error=None)
    try:
        handle, offset = ntt_rdma.ipc_export(x)
        mine.update(handle=handle, offset=offset, event=ev.ipc_handle())
        out["offset"] = offset
    except RuntimeError as e:          # the probe reports CUDA's refusal
        mine["error"] = out["export_error"] = str(e)
    try:
        out["torch_offset"] = x.untyped_storage()._share_cuda_()[3]
    except Exception as e:             # torch's private export, for comparison
        out["torch_offset"] = f"{type(e).__name__}: {e}"
    both = [None, None]
    torch.distributed.all_gather_object(both, mine)
    theirs = both[1 - rank]
    base = None
    if theirs["error"] is None and mine["error"] is None:
        try:
            base = ntt_rdma.ipc_open(theirs["handle"], dev)
            torch.cuda.current_stream(dev).wait_event(
                torch.cuda.Event.from_ipc_handle(dev, theirs["event"]))
            y = torch.zeros((1, WORDS), dtype=torch.int32, device=dev)
            tw = torch.zeros(WORDS, dtype=torch.int32, device=dev)
            got = ntt_rdma.stage([y], [ntt_rdma.Mapped(
                base + theirs["offset"], y)], [tw], [True])[0]
            torch.cuda.synchronize()
            want = torch.arange(WORDS, dtype=torch.int32) + 1000 * (2 - rank)
            out.update(read=got[0, :4].tolist() + got[0, -2:].tolist(),
                       matches=bool(torch.equal(got[0].cpu(), want)),
                       partner_offset=theirs["offset"])
        except RuntimeError as e:
            out["open_error"] = str(e)
    torch.distributed.barrier()        # both reads done before either frees
    if base is not None:
        ntt_rdma.ipc_close(base, dev)
    del pad
    out["ok"] = bool(out.get("matches"))
    print("IPC " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        return worker(int(sys.argv[i + 1]), sys.argv[i + 2])
    import torch
    from tpu_zkpool_torch.parallel import ntt_rdma
    if not torch.cuda.is_available():
        print("pod_ipc_probe: no CUDA device", file=sys.stderr)
        return 2
    ntt_rdma.build()                   # once, before both workers load it
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(2)]
    reports = 0
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=TIMEOUT_S)[0]
            lines = [ln for ln in out.splitlines() if ln.startswith("IPC ")]
            print(f"--- rank {r}, exit {p.returncode}, its last lines:")
            print("\n".join(out.splitlines()[-12:]))
            reports += bool(lines)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return 0 if reports == 2 else 1


if __name__ == "__main__":
    sys.exit(main())
