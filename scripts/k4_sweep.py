#!/usr/bin/env python3
"""Time K4 (``k_addn``, ``csrc/msm_grid.cu``) at several launch shapes on
one NVIDIA GPU, to choose its block size, register cap and product.

    python3 scripts/k4_sweep.py          # from the repository's root

It compiles ``msm_grid.cu``'s kernels (cut before their C launchers) with
one launcher of its own that instantiates ``k_addn`` at each variant of
``VARIANTS`` (field traits, block size, blocks an SM must hold), with
``-Xptxas -v``, into ``tpu_zkpool_torch/build/``. Over Fp and Fp2 it times
every variant by CUDA events (50 launches after one warm-up; three rounds,
the variants in turns) in the plain mode at 81,920 rows (the prover's
``B`` call) and 20,480 rows (its ``excl`` call), on rows of seeded random
points, and holds each output to the production kernel's
(``kernels.addn``) limb for limb. It prints the card, then one JSON line a
variant: registers, spill stores, waves at both row counts (blocks over
SMs x the blocks an SM holds at those registers), the rounds' ms at both,
max |err|.
"""

import ctypes
import json
import os
import random
import subprocess
import sys

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch import cuda_build  # noqa: E402
from tpu_zkpool_torch.msm import kernels  # noqa: E402

# (traits, block, blocks an SM must hold); the register cap is 65,536 /
# (block x blocks), at most 255. The first of each field is the launch
# shape msm_grid.cu runs (AddnShape); Fp2FieldFast is Fp2Over<FpFieldFast>.
VARIANTS = {
    1: [("FpField", 32, 12), ("FpFieldFast", 32, 12), ("FpField", 128, 1),
        ("FpFieldFast", 128, 1), ("FpField", 64, 8), ("FpFieldFast", 128, 4)],
    2: [("Fp2Over<FpFieldFast>", 32, 12), ("Fp2Over<FpField>", 32, 12),
        ("Fp2Over<FpFieldFast>", 128, 2), ("Fp2Over<FpFieldFast>", 64, 6),
        ("Fp2Over<FpFieldFast>", 64, 8)],
}
ROWS = (81920, 20480)
ROUNDS = 3


def source():
    with open(os.path.join(cuda_build.CSRC, kernels.SOURCE)) as f:
        cu = f.read()
    cu = cu[:cu.rindex("}  // namespace zk") + len("}  // namespace zk")]
    cases = []
    for ncomp, vs in VARIANTS.items():
        for v, (tr, blk, mb) in enumerate(vs):
            kern = f"zk::k_addn<zk::{tr.replace('<', '<zk::')}, {blk}, {mb}>"
            cases.append(
                f"  if (ncomp == {ncomp} && v == {v}) {{\n"
                f"    {kern}<<<(n + {blk - 1}) / {blk}, {blk}, 0, s>>>("
                "a, b, nullptr, nullptr, nullptr, out, n, n, n, 0);\n"
                "    return (int)cudaGetLastError();\n  }\n")
    return cu + """
extern "C" int sweep_addn(int ncomp, int v, const int64_t* a,
                          const int64_t* b, int64_t* out, int n,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
""" + "".join(cases) + "  return (int)cudaErrorInvalidValue;\n}\n"


def build():
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "k4_sweep.cu")
    lib = os.path.join(cuda_build.BUILD_DIR, "libk4_sweep.so")
    with open(src, "w") as f:
        f.write(source())
    res = subprocess.run(
        [cuda_build._nvcc()] + cuda_build.NVCC_FLAGS
        + ["-Xptxas", "-v", f"-I{cuda_build.CSRC}", "-o", lib, src],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    return lib, cs.ptxas_summary(res.stdout + res.stderr, ("k_addn<",))


def main():
    if not torch.cuda.is_available():
        print("k4_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    lib_path, ptxas = build()
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sweep_addn.argtypes = [I, I, P, P, P, I, P]
    sms = cs._sms(dev)
    rng = random.Random(4)
    for ncomp, vs in VARIANTS.items():
        pool = cs._rows(ncomp, cs._points(ncomp, 4096, 60 + ncomp),
                        rng).to(dev)
        rows = {n: (pool[torch.arange(n, device=dev) % 4096].contiguous(),
                    pool[(torch.arange(n, device=dev) * 7 + 1) % 4096]
                    .contiguous()) for n in ROWS}
        want = {n: kernels.addn(a, b) for n, (a, b) in rows.items()}
        res = []
        for tr, blk, mb in vs:
            r = ptxas[next(k for k in ptxas
                           if k.startswith(f"k_addn<{tr}, {blk}, {mb}>"))]
            regs = r.get("registers", 255)
            # registers are allocated 8 a thread at a time
            per_sm = min(65536 // (-(-regs // 8) * 8 * blk), 2048 // blk, 32)
            res.append(dict(ncomp=ncomp, traits=tr, block=blk, min_blocks=mb,
                            registers=regs, spill=r.get("spill_stores"),
                            blocks_a_sm=per_sm, waves={
                                n: -(-n // blk) / (sms * per_sm)
                                for n in ROWS},
                            ms={n: [] for n in ROWS}, max_abs_err=0))
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for _ in range(ROUNDS):                  # the variants in turns
            for v, out in enumerate(res):
                for n, (a, b) in rows.items():
                    o = torch.empty_like(a)

                    def call():
                        rc = lib.sweep_addn(ncomp, v, a.data_ptr(),
                                            b.data_ptr(), o.data_ptr(), n,
                                            stream)
                        if rc:
                            raise RuntimeError(f"sweep_addn: error {rc}")
                        return o

                    out["ms"][n].append(cs._cuda_ms(call, 50)[0])
                    out["max_abs_err"] = max(out["max_abs_err"], int(
                        (o - want[n]).abs().max().item()))
        for out in res:
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
