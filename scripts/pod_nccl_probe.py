#!/usr/bin/env python3
"""Try NCCL with two ranks on one card, once, and print what NCCL says.

    python3 scripts/pod_nccl_probe.py        # on a machine with a CUDA card

Two worker processes of this script start ``multihost.initialize(...,
backend="nccl")`` with ``LOCAL_RANK=0`` in both, so both ranks take cuda:0,
and all-gather one small CUDA tensor. NCCL is expected to refuse two ranks
on one card (an error of the form "Duplicate GPU detected"); that is why
``chip_smoke.py`` phase 14 joins its two processes over Gloo. Each rank's
outcome (the all-gather's values, or the exception's type and message)
is printed as one "NCCL" JSON line; the script exits 0 once both workers
have reported, whatever NCCL said, and non-zero if a worker hangs or
crashes without a report.
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


def worker(rank: int, port: str) -> int:
    import torch
    from tpu_zkpool_torch.parallel import initialize
    out = dict(rank=rank)
    try:
        initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                   backend="nccl",
                   timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
        x = torch.full((4,), rank + 1, device="cuda:0")
        bufs = [torch.empty_like(x) for _ in range(2)]
        torch.distributed.all_gather(bufs, x)
        torch.cuda.synchronize()
        out.update(ok=True, gathered=[b.tolist() for b in bufs])
    except Exception as e:             # the probe reports NCCL's refusal
        out.update(ok=False, error=type(e).__name__, message=str(e)[:2000])
    print("NCCL " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        return worker(int(sys.argv[i + 1]), sys.argv[i + 2])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, LOCAL_RANK="0", NCCL_DEBUG="WARN")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(2)]
    reports = 0
    try:
        for r, p in enumerate(procs):
            out = p.communicate(timeout=TIMEOUT_S)[0]
            lines = [ln for ln in out.splitlines() if ln.startswith("NCCL ")]
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
