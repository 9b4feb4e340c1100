"""Wrappers of the H(X) kernels P4 and P5 (``csrc/fr_ntt.cu``).

P4 (``stage``) is one radix-2 Fr NTT stage with its optional fused steps,
P5 (``pointwise``) an element-wise Fr product or the coset quotient. They
replace no ``pl.pallas_call``: the JAX package compiles the same steps
into one XLA program (``tpu_zkpool/groth16/prove_tpu.py:_h_pipeline``,
l.238; ``tpu_zkpool/groth16/domain.py:forward`` l.73, ``inverse`` l.91).
Their plain versions are ``groth16.domain.stage_plain`` and
``pointwise_plain``. Each wrapper:

- raises ``ValueError`` on either device for inputs of the wrong shape or
  dtype (int64 limbs ``[..., 16]``);
- sends a CPU tensor to the plain version;
- on a CUDA tensor checks device and contiguity, allocates its output with
  ``torch.empty`` unless given one, launches on the current stream, raises
  if the launch reported an error, and adds one to its ``LAUNCHES`` count.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields.limbs import NLIMB
from tpu_zkpool_torch.groth16 import domain

SOURCE = "fr_ntt.cu"
MAX_LOG_N = 28                 # csrc/fr_ntt.cu:kFrMaxLogN (Fr - 1 = 2^28 odd)

# Launches since the last reset (a path's evidence that it ran through the
# kernels).
LAUNCHES = {"fr_stage": 0, "fr_pointwise": 0}

_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(extra_flags=()) -> tuple:
    """Compile P4 and P5 unless their library exists: (path, nvcc output or
    None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = cuda_build.load(SOURCE, {
            "fr_stage": [P, P, P, P, P, P, L, I, I, I, I, P],
            "fr_pointwise": [P, P, P, P, P, L, P]})
    return _lib


def _limbs(x, name, what, shape=None):
    """Raise unless ``x`` is int64 ``[..., 16]`` (of ``shape`` if given)."""
    if x.dim() < 1 or x.shape[-1] != NLIMB or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        want = f"{tuple(shape)}" if shape is not None else "(..., 16)"
        raise ValueError(f"{name}: {what} must be {want} limbs, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise ValueError(f"{name}: {what} must be int64 limbs, got {x.dtype}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def stage(y, pw, h: int, dif: bool, *, pre=None, bitrev: bool = False,
          post=None, post_scalar=None, out=None):
    """P4: one radix-2 stage of half-width ``h`` over int64[..., n, 16]
    Montgomery values (axis -2), twiddle k of the stage ``pw[k n / 2h]``
    from the direction's power table ``pw`` (n/2, 16); ``dif`` picks the
    forward (DIF) butterfly, else the inverse (DIT) one. The fused steps
    (``stage_plain``): ``bitrev`` reads the input in bit-reversed order,
    ``pre`` (n, 16) multiplies the inputs, ``post`` (n, 16) and
    ``post_scalar`` (16,) the outputs. ``out`` may be ``y`` itself (an
    in-place stage) unless ``bitrev``."""
    name = "fr_stage"
    _limbs(y, name, "values")
    if y.dim() < 2:
        raise ValueError(f"{name}: values must be (..., n, 16), got "
                         f"{tuple(y.shape)}")
    n = y.shape[-2]
    if n < 2 or n & (n - 1) or n > 1 << MAX_LOG_N:
        raise ValueError(f"{name}: n must be a power of two in [2, 2^28], "
                         f"got {n}")
    if h < 1 or h & (h - 1) or h > n // 2:
        raise ValueError(f"{name}: h must be a power of two in [1, n/2], "
                         f"got {h}")
    _limbs(pw, name, "the power table", (n // 2, NLIMB))
    for t, what in ((pre, "pre"), (post, "post")):
        if t is not None:
            _limbs(t, name, what, (n, NLIMB))
    if post_scalar is not None:
        _limbs(post_scalar, name, "post_scalar", (NLIMB,))
    if out is not None:
        _limbs(out, name, "out", y.shape)
        if bitrev and out.data_ptr() == y.data_ptr():
            raise ValueError(f"{name}: a bit-reversed read runs out of place")
    if y.device.type == "cpu":
        res = domain.stage_plain(y, pw[:: n // (2 * h)], dif, pre=pre,
                                 bitrev=bitrev, post=post,
                                 post_scalar=post_scalar)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    ts = [t for t in (y, out, pw, pre, post, post_scalar) if t is not None]
    cuda_build.check_tensors(name, *ts)
    if y.numel() == 0:
        return out
    cuda_build.launch(LAUNCHES, name, y.device, _load().fr_stage,
                      y.data_ptr(), out.data_ptr(), pw.data_ptr(), _ptr(pre),
                      _ptr(post), _ptr(post_scalar), y.numel() // (n * NLIMB),
                      n.bit_length() - 1, h.bit_length() - 1, int(dif),
                      int(bitrev))
    return out


def pointwise(a, t, b=None, c=None, *, out=None):
    """P5 over int64[..., 16] Montgomery values ``a``: ``a t`` (mode mul),
    or ``(a b - c) t`` (the quotient) with ``b`` and ``c`` shaped as ``a``;
    ``t`` is one value (16,). ``out`` may be ``a`` itself."""
    name = "fr_pointwise"
    _limbs(a, name, "a")
    _limbs(t, name, "t", (NLIMB,))
    if (b is None) != (c is None):
        raise ValueError(f"{name}: b and c come together")
    for x, what in ((b, "b"), (c, "c"), (out, "out")):
        if x is not None:
            _limbs(x, name, what, a.shape)
    N = a.numel() // NLIMB
    if a.device.type == "cpu":
        res = domain.pointwise_plain(a, t, b, c)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(a, memory_format=torch.contiguous_format)
    ts = [x for x in (a, t, b, c, out) if x is not None]
    cuda_build.check_tensors(name, *ts)
    if N == 0:
        return out
    cuda_build.launch(LAUNCHES, name, a.device, _load().fr_pointwise,
                      a.data_ptr(), _ptr(b), _ptr(c), t.data_ptr(),
                      out.data_ptr(), N)
    return out
