"""Wrappers of the H(X) kernels P4 and P5 (``csrc/fr_ntt.cu``).

P4 (``fr_pass``) is a pass of up to ``max_pass`` radix-2 Fr NTT stages in
shared memory with its optional fused steps, P5 (``pointwise``) an
element-wise Fr product by one value. They replace no
``pl.pallas_call``: the JAX package compiles the same steps into one XLA
program (``tpu_zkpool/groth16/prove_tpu.py:_h_pipeline``, l.239;
``tpu_zkpool/groth16/domain.py:forward`` l.73, ``inverse`` l.91). Their
plain versions are ``groth16.domain.pass_plain`` and ``pointwise_plain``.
Each wrapper:

- raises ``ValueError`` on either device for inputs of the wrong shape or
  dtype (int64 limbs ``[..., 16]``, P4's tables int32 words ``[..., 8]``);
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
WORDS = NLIMB // 2             # words of a packed table value

# Launches since the last reset (a path's evidence that it ran through the
# kernels).
LAUNCHES = {"fr_pass": 0, "fr_pointwise": 0}

_lib = None
_max_pass = None


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
            "fr_pass": [P] * 9 + [L, I, I, I, I, I, P],
            "fr_pointwise": [P, P, P, L, P], "fr_max_pass": []})
    return _lib


def max_pass(device) -> int:
    """The most stages a P4 launch runs on ``device``: the tile the
    library was built with (``csrc/fr_ntt.cu:kFrTileLog``), read once.
    Raises ``ValueError`` off CUDA: the plain form has no tile."""
    global _max_pass
    if torch.device(device).type != "cuda":
        raise ValueError(f"fr_pass: tensors must be on a CUDA device, got "
                         f"{device}")
    if _max_pass is None:
        _max_pass = _load().fr_max_pass()
    return _max_pass


def _limbs(x, name, what, shape=None, dtype=torch.int64, width=NLIMB):
    """Raise unless ``x`` is ``dtype`` ``[..., width]`` (of ``shape`` if
    given): int64 limbs by default, P4's tables int32 words."""
    if x.dim() < 1 or x.shape[-1] != width or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        want = f"{tuple(shape)}" if shape is not None else f"(..., {width})"
        kind = "limbs" if width == NLIMB else "words"
        raise ValueError(f"{name}: {what} must be {want} {kind}, got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: {what} must be {dtype}, got {x.dtype}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def fr_pass(y, pw, h_first: int, count: int, dif: bool, *, pre=None,
            bitrev: bool = False, post=None, post_scalar=None,
            quotient=None, out=None):
    """P4: ``count`` radix-2 stages over int64[..., n, 16] Montgomery values
    (axis -2) from half-width ``h_first``, halving (``dif``, the forward
    butterfly) or doubling (the inverse one), in one launch; twiddle k of a
    stage of half-width h is ``pw[k n / 2h]`` of the direction's packed
    power table ``pw`` int32 (n/2, 8). The fused steps (``pass_plain``):
    ``bitrev`` reads the input in bit-reversed order, ``quotient = (b, c,
    t)`` (b, c shaped as ``y``, t (16,)) turns the values read into (y b -
    c) t, ``pre`` int32 (n, 8) multiplies the first stage's inputs,
    ``post`` int32 (n, 8) and ``post_scalar`` (16,) the last stage's
    outputs. ``out`` may be ``y`` itself (an in-place pass) unless
    ``bitrev``."""
    name = "fr_pass"
    _limbs(y, name, "values")
    if y.dim() < 2:
        raise ValueError(f"{name}: values must be (..., n, 16), got "
                         f"{tuple(y.shape)}")
    n = y.shape[-2]
    if n < 2 or n & (n - 1) or n > 1 << MAX_LOG_N:
        raise ValueError(f"{name}: n must be a power of two in [2, 2^28], "
                         f"got {n}")
    if count < 1:
        raise ValueError(f"{name}: count must be at least 1, got {count}")
    domain.pass_half_widths(n, h_first, count, dif)
    _limbs(pw, name, "the power table", (n // 2, WORDS), torch.int32, WORDS)
    for t, what in ((pre, "pre"), (post, "post")):
        if t is not None:
            _limbs(t, name, what, (n, WORDS), torch.int32, WORDS)
    if post_scalar is not None:
        _limbs(post_scalar, name, "post_scalar", (NLIMB,))
    qb = qc = qt = None
    if quotient is not None:
        qb, qc, qt = quotient
        _limbs(qb, name, "the quotient's b", y.shape)
        _limbs(qc, name, "the quotient's c", y.shape)
        _limbs(qt, name, "the quotient's t", (NLIMB,))
    if out is not None:
        _limbs(out, name, "out", y.shape)
        if bitrev and out.data_ptr() == y.data_ptr():
            raise ValueError(f"{name}: a bit-reversed read runs out of place")
    if y.device.type == "cpu":
        res = domain.pass_plain(y, pw, h_first, count, dif, pre=pre,
                                bitrev=bitrev, post=post,
                                post_scalar=post_scalar, quotient=quotient)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(y, memory_format=torch.contiguous_format)
    cuda_build.check_tensors(name, *[t for t in (
        y, out, post_scalar, qb, qc, qt) if t is not None])
    words = [t for t in (pw, pre, post) if t is not None]
    cuda_build.check_tensors(name, *words, dtype=torch.int32)
    if any(t.device != y.device for t in words):
        raise ValueError(f"{name}: the tables must be on {y.device}")
    if count > max_pass(y.device):
        raise ValueError(f"{name}: count must be at most the tile's "
                         f"{max_pass(y.device)} stages, got {count}")
    if y.numel() == 0:
        return out
    cuda_build.launch(LAUNCHES, name, y.device, _load().fr_pass,
                      y.data_ptr(), out.data_ptr(), pw.data_ptr(), _ptr(pre),
                      _ptr(post), _ptr(post_scalar), _ptr(qb), _ptr(qc),
                      _ptr(qt), y.numel() // (n * NLIMB),
                      n.bit_length() - 1, h_first.bit_length() - 1, count,
                      int(dif), int(bitrev))
    return out


def pointwise(a, t, *, out=None):
    """P5: ``a t`` over int64[..., 16] Montgomery values ``a``, ``t`` one
    value (16,). ``out`` may be ``a`` itself."""
    name = "fr_pointwise"
    _limbs(a, name, "a")
    _limbs(t, name, "t", (NLIMB,))
    if out is not None:
        _limbs(out, name, "out", a.shape)
    N = a.numel() // NLIMB
    if a.device.type == "cpu":
        res = domain.pointwise_plain(a, t)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(a, memory_format=torch.contiguous_format)
    cuda_build.check_tensors(name, a, t, out)
    if N == 0:
        return out
    cuda_build.launch(LAUNCHES, name, a.device, _load().fr_pointwise,
                      a.data_ptr(), t.data_ptr(), out.data_ptr(), N)
    return out
