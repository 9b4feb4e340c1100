"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each ``.cu`` file builds with ``nvcc`` at first use into its own plain-C
shared library in ``tpu_zkpool_torch/build/`` (gitignored), loaded with
ctypes. A library's name carries a hash of the flags, the ``.cu`` and every
shared header of ``csrc/``, so an edit to any of them builds anew. The
kernel wrappers (``msm/kernels.py``, ``hash/kernels.py``,
``msm/tree_kernels.py``, ``parallel/ntt_rdma.py``) share the checks and the
launch here: tensors must be contiguous, of the kernel's dtype, on one CUDA
device, a launcher returns ``cudaGetLastError()`` and a nonzero code
raises, and each launch adds one to the wrapper's count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(cu: str) -> str:
    """The shared library of ``csrc/<cu>`` for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in headers + [cu]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    stem = os.path.splitext(cu)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build(cu: str, extra_flags=()) -> tuple:
    """Compile ``csrc/<cu>`` unless its library exists. Returns (path, nvcc
    output or None when cached); raises if nvcc fails."""
    path = library_path(cu)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + NVCC_FLAGS + list(extra_flags)
           + ["-o", tmp, os.path.join(CSRC, cu)])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path, res.stdout + res.stderr


def load(cu: str, signatures: dict) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<cu>``; ``signatures`` maps each
    launcher to its argtypes (all return an int error code)."""
    lib = ctypes.CDLL(build(cu)[0])
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_tensors(name, *tensors, dtype=torch.int64):
    """Raise ``ValueError`` unless the tensors are contiguous ``dtype``
    (int64 limbs for K1-K8, int32 words for K9) on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} tensors on one "
                             f"device, got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")


def launch(counts: dict, name: str, device, fn, *args):
    """Call launcher ``fn`` on ``device``'s current stream; raise on the
    error it returns, else add one to ``counts[name]``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    counts[name] += 1
