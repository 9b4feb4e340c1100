"""Grid-accumulator Pippenger MSM over G1 and G2 (the port of
``tpu_zkpool/msm/grid.py``).

Pipeline per slice of points, the same as the JAX package's:

1. signed window digits from 16-bit scalar limbs,
2. per window: sort the points by |digit| (one ``torch.sort`` of the bucket
   keys per column, the packed index | sign payload gathered alongside),
3. bucket sums via a chunk-contiguous inclusive prefix scan: ``lanes``
   chunks of ``k = N / lanes`` sorted points, one mixed Jacobian + affine add
   per step - the O(N * W) bulk, every window in one launch of kernel K1
   (``prefix_rows``), which gathers its rows by the payload and writes the
   prefix in sorted order,
4. cross-chunk prefix in two levels (K2, ``prefix``: W * lanes / 32 lanes
   of 32 steps, then W lanes of lanes / 32), bucket values
   from boundary differences (K4, ``addn``, which gathers its operands by
   index, negates and masks them itself) at the bucket starts, found for
   all windows by one batched ``searchsorted`` (no host sync),
5. bucket reduction sum_j j * B_j with the weighted-suffix identity (K3,
   ``wsum``: one launch over the W C chunks, one over their 2 W totals;
   then K5, ``scale_add``),
6. the Horner window combine (K6, ``horner``).

With ``tree=True`` a G1 MSM replaces steps 3-4 by the batched-affine
pairwise tree over each window's sorted segments (``msm/affine_tree.py``,
kernel K8, ``tree_level``); G2 keeps the prefix path.

Each of K1-K6 is a CUDA kernel (``csrc/msm_grid.cu``, wrappers in
``msm/kernels.py``) with a plain PyTorch twin here (``*_plain``). A CPU tensor
goes to the twin, a CUDA tensor to the kernel. Sorting, the bucket starts
and the index vectors are torch ops; the boundary gathers, the selects and
the Y negations around K4, XLA glue in JAX, are K4's own loads.

Point rows are ``int64[n, 3, ncomp, 16]``: Jacobian (X, Y, Z) Montgomery
limbs, ncomp = 1 (Fp, G1) or 2 (Fp2, G2), Z = 0 the identity.

The point formulas are generic over a field adapter whose elements are
limb-major ``int64[16, ncomp, *batch]``; a point stacks its coordinates,
``int64[C, 16, ncomp, *batch]``. ``muls`` takes several independent
products at once and runs them as one batched Montgomery multiplication,
so each formula issues one field-op call per dependency level; the values
are those of the JAX formulas, op for op.
"""

from __future__ import annotations

import functools

import torch

from tpu_zkpool_torch.fields import bn254
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.fields.limbs import NLIMB, WBITS
# kernels imports this module for the plain twins; both only use each
# other's names inside functions, so the import cycle is benign.
from tpu_zkpool_torch.msm import affine_tree, kernels
from tpu_zkpool_torch.utils.metrics import span

TILE_N = 1024      # default lanes: chunks per prefix scan
SCALAR_BITS = 255  # BN254 Fr < 2^254; one guard bit for the signed recode
# Max points per sub-MSM slice; larger sets fold per-slice window sums.
SUB_LOG2 = 17


# --------------------------------------------------------------------------
# Field adapters over limb-major elements (16, ncomp, *batch).
# --------------------------------------------------------------------------


class _TFp:
    ncomp = 1

    @staticmethod
    def muls(*pairs):
        a = torch.stack([x for x, _ in pairs], 1)
        b = torch.stack([y for _, y in pairs], 1)
        return FP.lm_mul(a, b).unbind(1)

    add = staticmethod(FP.lm_add)
    sub = staticmethod(FP.lm_sub)

    @staticmethod
    def dbl(a):
        return FP.lm_add(a, a)

    @staticmethod
    def is_zero(a):
        return (a == 0).flatten(0, 1).all(0)

    zero = staticmethod(torch.zeros_like)

    @staticmethod
    def one(like):
        out = torch.zeros_like(like)
        r1 = FP.ones_mont((), like.device)
        out[:, 0] = r1.view((NLIMB,) + (1,) * (like.dim() - 2))
        return out

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond, a, b)


class _TFp2(_TFp):
    """Fp2 = Fp[u]/(u^2 + 1): Karatsuba (3 Fp products per Fp2 product),
    t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1), c = (t0 - t1,
    (t2 - t0) - t1). add/sub/dbl/select are componentwise (inherited)."""

    ncomp = 2

    @staticmethod
    def muls(*pairs):
        a = torch.stack([x for x, _ in pairs], 1)          # (16, k, 2, *B)
        b = torch.stack([y for _, y in pairs], 1)
        s = FP.lm_add(torch.stack([a[:, :, 0], b[:, :, 0]], 1),
                      torch.stack([a[:, :, 1], b[:, :, 1]], 1))
        t = FP.lm_mul(torch.stack([a[:, :, 0], a[:, :, 1], s[:, 0]], 2),
                      torch.stack([b[:, :, 0], b[:, :, 1], s[:, 1]], 2))
        t0, t1, t2 = t.unbind(2)
        u = FP.lm_sub(torch.stack([t0, t2], 1), torch.stack([t1, t0], 1))
        c1 = FP.lm_sub(u[:, 1], t1)
        return torch.stack([u[:, 0], c1], 2).unbind(1)


def _field(ncomp):
    return _TFp if ncomp == 1 else _TFp2


# --------------------------------------------------------------------------
# Jacobian point formulas (a = 0 curves).
# --------------------------------------------------------------------------


def _pdouble(F, P):
    X, Y, Z = P
    A, B, YZ = F.muls((X, X), (Y, Y), (Y, Z))
    xb = F.add(X, B)
    C, xb2 = F.muls((B, B), (xb, xb))
    D = F.dbl(F.sub(F.sub(xb2, A), C))
    E = F.add(F.dbl(A), A)
    (Fq,) = F.muls((E, E))
    X3 = F.sub(Fq, F.dbl(D))
    C8 = F.dbl(F.dbl(F.dbl(C)))
    (EDX,) = F.muls((E, F.sub(D, X3)))
    Y3 = F.sub(EDX, C8)
    Z3 = F.dbl(YZ)
    return torch.stack([X3, Y3, Z3])


def _finish(F, P, Q, R, H, r, complete, q_affine=False):
    """Special-case selects on stacked points (3, 16, ncomp, *B).
    ``complete=False`` (prover mode) skips the doubling branch (P == Q);
    P == -Q still lands on the identity since Z3 = Z1 Z2 H = 0. Identity
    operands are always handled."""
    p_inf = F.is_zero(P[2])
    q_inf = None if q_affine else F.is_zero(Q[2])
    if complete:
        same_x = F.is_zero(H)
        same_y = F.is_zero(r)
        finite = ~p_inf if q_inf is None else (~p_inf & ~q_inf)
        is_dbl = same_x & same_y & finite
        to_inf = same_x & ~same_y & finite
        if bool(is_dbl.any()):    # the doubling is selected nowhere else
            R = F.select(is_dbl, _pdouble(F, P), R)
        R = F.select(to_inf, 0, R)
    if q_affine:
        Q = torch.cat([Q, F.one(Q[0])[None]])
    R = F.select(p_inf, Q, R)
    if q_inf is not None:
        R = F.select(q_inf, P, R)
    return R


def _pmadd(F, P, Q, complete=True):
    """P (Jacobian) + Q ((X2, Y2) affine, Z2 = 1): 8M + 3S. Q is never the
    identity: the pipeline zeroes the digits of identity inputs."""
    X1, Y1, Z1 = P
    X2, Y2 = Q[0], Q[1]
    (Z1Z1,) = F.muls((Z1, Z1))
    U2, Z1c = F.muls((X2, Z1Z1), (Z1, Z1Z1))
    H = F.sub(U2, X1)
    S2, HH, Z3 = F.muls((Y2, Z1c), (H, H), (Z1, H))
    r = F.sub(S2, Y1)
    HHH, V, r2 = F.muls((H, HH), (X1, HH), (r, r))
    X3 = F.sub(F.sub(r2, HHH), F.dbl(V))
    t1, t2 = F.muls((r, F.sub(V, X3)), (Y1, HHH))
    Y3 = F.sub(t1, t2)
    return _finish(F, P, Q, torch.stack([X3, Y3, Z3]), H, r, complete,
                   q_affine=True)


def _padd(F, P, Q, complete=True):
    """General Jacobian addition: 12M + 4S."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1, Z2Z2, Z12 = F.muls((Z1, Z1), (Z2, Z2), (Z1, Z2))
    U1, U2, Z2c, Z1c = F.muls((X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2),
                              (Z1, Z1Z1))
    S1, S2 = F.muls((Y1, Z2c), (Y2, Z1c))
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    HH, r2, Z3 = F.muls((H, H), (r, r), (Z12, H))
    HHH, V = F.muls((H, HH), (U1, HH))
    X3 = F.sub(F.sub(r2, HHH), F.dbl(V))
    t1, t2 = F.muls((r, F.sub(V, X3)), (S1, HHH))
    Y3 = F.sub(t1, t2)
    return _finish(F, P, Q, torch.stack([X3, Y3, Z3]), H, r, complete)


# --------------------------------------------------------------------------
# Plain twins of the six kernels. Rows (..., C, ncomp, 16) convert to
# limb-major points (C x (16, ncomp, lanes)) once per call.
# --------------------------------------------------------------------------


def _to_lm(rows):
    """(..., lanes, C, ncomp, 16) -> (..., C, 16, ncomp, lanes)."""
    d = rows.dim()
    perm = tuple(range(d - 4)) + (d - 3, d - 1, d - 2, d - 4)
    return rows.permute(perm).contiguous()


def _from_lm(pts):
    """(..., C, 16, ncomp, lanes) -> (..., lanes, C, ncomp, 16)."""
    d = pts.dim()
    perm = tuple(range(d - 4)) + (d - 1, d - 4, d - 2, d - 3)
    return pts.permute(perm).contiguous()


def _zero_point(ncomp, lanes, device):
    return torch.zeros((3, NLIMB, ncomp, lanes), dtype=torch.int64,
                       device=device)


def prefix_rows_plain(xy, payload_t, complete):
    """K1 twin. xy (N, 2, ncomp, 16) affine source rows; payload_t (W, k,
    lanes) int64, index | neg << 31 (Y negates where neg is set) ->
    (W, k * lanes, 3, ncomp, 16): per window, each lane's inclusive prefix
    of mixed adds over its k steps, in sorted order (row l * k + j = step
    j of lane l). The steps run one after another with every window and
    lane batched."""
    W, k, lanes = payload_t.shape
    ncomp = xy.shape[2]
    F = _field(ncomp)
    pv = payload_t.transpose(0, 1).reshape(k, W * lanes)
    q = _to_lm(xy[pv & 0x7FFFFFFF])                # (k, 2, 16, nc, W*lanes)
    neg = (pv >> 31) != 0
    acc = _zero_point(ncomp, W * lanes, xy.device)
    out = []
    for j in range(k):
        x, y = q[j]
        y = F.select(neg[j], F.sub(F.zero(y), y), y)
        acc = _pmadd(F, acc, torch.stack([x, y]), complete)
        out.append(acc)
    pr = _from_lm(torch.stack(out))                # (k, W * lanes, 3, nc, 16)
    pr = pr.reshape((k, W, lanes) + pr.shape[2:]).permute(1, 2, 0, 3, 4, 5)
    return pr.reshape((W, lanes * k) + pr.shape[3:])


def prefix_plain(tiles, mixed, complete):
    """K2 twin. tiles (k, lanes, C, ncomp, 16), C = 2 (affine input, mixed
    segment adds) or 3 (Jacobian, general adds) -> (k, lanes, 3, ncomp, 16)
    inclusive prefix sums over the k steps, by the kernel's schedule
    (``prefix_schedule``: T segments of s steps), add for add in the same
    operand order:

    1. segment t (steps t s .. t s + s - 1, those below k) serially: its
       first step as is (an identity Jacobian input as O, as O + Q gives
       it; an affine input with Z = 1), then a = a + q (``complete`` sets
       the doubling branch of these adds);
    2. inclusive scan of the segment totals a_t (Kogge-Stone, d = 1, 2,
       4, ...: a_t = a_(t-d) + a_t where t >= d);
    3. each output of segment t >= 1 becomes a_(t-1) + its segment prefix.

    The scan and carry adds are complete. A segment past k is empty, its
    total the identity, which passes through a complete add unchanged."""
    k, lanes, C, ncomp, _ = tiles.shape
    if C != (2 if mixed else 3):
        raise ValueError(f"prefix: {C} coordinates for mixed={mixed}")
    F = _field(ncomp)
    T, log2s = prefix_schedule(k)
    s = 1 << log2s
    pad = _pad_rows(tiles, T * s).reshape((T, s, lanes) + tiles.shape[2:])
    q = _to_lm(pad.transpose(0, 1).reshape((s, T * lanes) + tiles.shape[2:]))
    # valid[j] over the T * lanes batch: step t s + j < k
    step = torch.arange(T, device=tiles.device)[:, None] * s
    live = (step + torch.arange(s, device=tiles.device) < k).T
    live = live.repeat_interleave(lanes, 1)            # (s, T * lanes)
    zero = _zero_point(ncomp, T * lanes, tiles.device)
    pre = []
    for j in range(s):
        x = q[j]
        if j == 0:
            a = (torch.cat([x, F.one(x[0])[None]]) if mixed
                 else F.select(F.is_zero(x[2]), zero, x)).where(live[0], zero)
        else:
            a = (_pmadd(F, a, x, complete) if mixed
                 else _padd(F, a, x)).where(live[j], a)
        pre.append(a)

    def seg(P):                                    # (3, 16, nc, T', lanes)
        return P.reshape(P.shape[:3] + (-1, lanes))

    def flat(P):
        return P.reshape(P.shape[:3] + (-1,))

    a = seg(a)
    d = 1
    while d < T:
        a = torch.cat([a[..., :d, :], seg(_padd(F, flat(a[..., :T - d, :]),
                                                flat(a[..., d:, :])))], 3)
        d *= 2
    # (3, 16, nc, s, T, lanes): segment prefixes, then the carries for t >= 1
    P = torch.stack(pre, 3).reshape((3, NLIMB, ncomp, s, T, lanes))
    if T > 1:
        cy = a[..., :T - 1, :].unsqueeze(3).expand(-1, -1, -1, s, -1, -1)
        add = _padd(F, flat(cy), flat(P[..., 1:, :]))
        P = torch.cat([P[..., :1, :], add.reshape(cy.shape)], 4)
    out = P.permute(4, 3, 5, 0, 2, 1).reshape((T * s, lanes, 3, ncomp, NLIMB))
    return out[:k].contiguous()


WARP = 32          # K2's and K3's segments per lane: one warp's threads


def wsum_schedule(L: int):
    """K3's schedule for L steps, shared by the kernel (through its
    wrapper) and the twin: (T, log2 s), T = min(L, 32) segments of s steps,
    s the power of two >= ceil(L / T); steps L .. T s - 1 are identities."""
    T = min(L, WARP)
    return T, (-(-L // T) - 1).bit_length()


def prefix_schedule(k: int):
    """K2's schedule for k steps, shared by the kernel (through its
    wrapper) and the twin: the split of ``wsum_schedule``, (T, log2 s)
    with T = min(k, 32) segments of s = 2^log2s >= ceil(k / T) steps."""
    return wsum_schedule(k)


def wsum_plain(steps):
    """K3 twin. steps (L, lanes, 3, ncomp, 16) B_l -> (2, lanes, 3, ncomp,
    16): acc = sum_l B_l, tot = sum_l (l + 1) B_l, by the kernel's
    schedule (``wsum_schedule``), add for add in the same operand order:

    1. segment t (steps t s .. t s + s - 1), fed from its top step down:
       a = a + B, w = w + a; so a_t = its sum, w_t = sum_j (j + 1) B_(ts+j);
    2. inclusive suffix scan of a_t (Kogge-Stone, d = 1, 2, 4, ...:
       a_t = a_t + a_(t+d) where t + d < T); acc = a_0;
    3. x_t = w_t + 2^log2s S_t with S_t = a_(t+1) (the exclusive suffix,
       the identity at t = T - 1), the power by log2 s doublings;
    4. tot = x_0 after the tree x_t = x_t + x_(t+d), d = 1, 2, 4, ...
       (t a multiple of 2d, t + d < T).

    tot = sum_t (w_t + s S_t) = sum_l (l + 1) B_l, since sum_t S_t counts
    a_u u times. Identity operands pass through the complete adds
    unchanged, so padding steps change no value."""
    L, lanes, _, ncomp, _ = steps.shape
    F = _field(ncomp)
    T, log2s = wsum_schedule(L)
    s = 1 << log2s
    pad = _pad_rows(steps, T * s).reshape((T, s, lanes) + steps.shape[2:])
    q = _to_lm(pad.transpose(0, 1).reshape((s, T * lanes) + steps.shape[2:]))
    a = w = _zero_point(ncomp, T * lanes, steps.device)
    for j in range(s - 1, -1, -1):
        a = _padd(F, a, q[j])
        w = _padd(F, w, a)

    def seg(P):                                    # (3, 16, nc, T', lanes)
        return P.reshape(P.shape[:3] + (-1, lanes))

    def flat(P):
        return P.reshape(P.shape[:3] + (-1,))

    a, w = seg(a), seg(w)
    d = 1
    while d < T:
        a = torch.cat([seg(_padd(F, flat(a[..., :T - d, :]),
                                 flat(a[..., d:, :]))), a[..., T - d:, :]], 3)
        d *= 2
    S = torch.cat([a[..., 1:, :], torch.zeros_like(a[..., :1, :])], 3)
    S = flat(S)
    for _ in range(log2s):
        S = _pdouble(F, S)
    x = seg(_padd(F, flat(w), S))
    d = 1
    while d < T:
        lo = x[..., 0:T - d:2 * d, :]
        hi = x[..., d:T:2 * d, :]
        x = x.clone()
        x[..., 0:T - d:2 * d, :] = seg(_padd(F, flat(lo), flat(hi)))
        d *= 2
    return _from_lm(torch.stack([a[..., 0, :], x[..., 0, :]]))


def _gather_rows(rows, idx):
    """rows[idx], a row of zeros where idx < 0 (rows itself if idx is
    None)."""
    if idx is None:
        return rows
    return torch.where((idx < 0)[:, None, None, None], 0,
                       rows[idx.clamp(min=0)])


def addn_plain(a, b, ia=None, ib=None, neg_b=False, zero=None):
    """K4 twin: lane-parallel complete Jacobian A(i) + B(i) on (., 3, ncomp,
    16) rows, A and B gathered by ``ia`` and ``ib`` (a row of zeros where
    an index is < 0), B's Y negated if ``neg_b``, rows zeroed where
    ``zero`` (``kernels.addn`` states the function): plain torch gathers,
    selects and ``rows_neg_y`` around the complete add."""
    A, B = _gather_rows(a, ia), _gather_rows(b, ib)
    if neg_b:
        B = rows_neg_y(B)
    out = _from_lm(_padd(_field(a.shape[2]), _to_lm(A), _to_lm(B)))
    if zero is not None:
        out = torch.where(zero[:, None, None, None], 0, out)
    return out


def scale_add_plain(a, b, log2s):
    """K5 twin: 2^log2s * a + b on (n, 3, ncomp, 16)."""
    F = _field(a.shape[2])
    P = _to_lm(a)
    for _ in range(log2s):
        P = _pdouble(F, P)
    return _from_lm(_padd(F, P, _to_lm(b)))


def horner_plain(S, c):
    """K6 twin: S (W, 3, ncomp, 16) window sums -> sum_w 2^(c w) S_w as one
    row (3, ncomp, 16): per step, c doublings, then add the next sum.
    S (V, W, 3, ncomp, 16) gives V rows (V, 3, ncomp, 16), each its own
    sum, in one pass."""
    one = S.dim() == 4
    S = S[None] if one else S
    V, W, _, ncomp, _ = S.shape
    F = _field(ncomp)
    q = _to_lm(S.transpose(0, 1))                  # (W, 3, 16, nc, V)
    acc = _zero_point(ncomp, V, S.device)
    for t in range(W - 1, -1, -1):
        for _ in range(c):
            acc = _pdouble(F, acc)
        acc = _padd(F, acc, q[t])
    out = _from_lm(acc)
    return out[0] if one else out


# --------------------------------------------------------------------------
# Signed window digits.
# --------------------------------------------------------------------------


def n_windows(c: int, nbits: int = SCALAR_BITS) -> int:
    return -(-nbits // c)


def signed_digits(limbs, c: int, nbits: int = SCALAR_BITS):
    """int64[N, 16] plain scalar limbs -> (bucket int64[N, W] in
    [0, 2^(c-1)], neg bool[N, W]); scalar = sum_w sign_w bucket_w 2^(c w).
    ``nbits`` narrows the recode for scalars known to be < 2^(nbits-1)."""
    W = n_windows(c, nbits)
    cmask = (1 << c) - 1
    half = 1 << (c - 1)
    raw = []
    for w in range(W):
        o = w * c
        lo, sh = o // WBITS, o % WBITS
        v = limbs[:, lo] >> sh
        if lo + 1 < NLIMB and sh + c > WBITS:
            v = v | (limbs[:, lo + 1] << (WBITS - sh))
        raw.append(v & cmask)
    digits = []
    carry = torch.zeros_like(raw[0])
    for w in range(W):
        d = raw[w] + carry
        carry = (d > half).long()
        digits.append(d - (carry << c))
    dig = torch.stack(digits, 1)
    return dig.abs(), dig < 0


# --------------------------------------------------------------------------
# Full MSM.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _safe_point_host(ncomp: int):
    if ncomp == 1:
        xy = [[bn254.G1_GX], [bn254.G1_GY]]
    else:
        xy = [list(bn254.G2_GX), list(bn254.G2_GY)]
    return FP.to_mont(xy)


def _safe_point(ncomp: int, device):
    """A valid curve point substituted for identity inputs (their digits
    are zeroed, so it never contributes): the G1 / G2 generator as
    (2, ncomp, 16) Montgomery limbs."""
    return torch.as_tensor(_safe_point_host(ncomp), device=device)


def _reduction_shape(half: int):
    """Bucket axis half = C * L for the two-level weighted suffix
    reduction: L = per-wsum steps (<= 128), C = chunk count."""
    L = min(128, half)
    C = half // L
    assert C * L == half
    return C, L


def _pad_rows(rows, n):
    pad = n - rows.shape[0]
    assert pad >= 0, (rows.shape, n)
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
    return rows


def rows_neg_y(rows):
    """Negate the Y coordinate of point rows (componentwise p - y)."""
    out = rows.clone()
    out[:, 1] = FP.neg(rows[:, 1])
    return out


def _prefix_chunks(rows, k):
    """Jacobian prefix over chunk-contiguous rows (lanes * k, 3, nc, 16):
    row i is step i % k of lane i // k."""
    lanes = rows.shape[0] // k
    tiles = rows.reshape((lanes, k) + rows.shape[1:]).transpose(0, 1)
    out = kernels.prefix(tiles.contiguous(), mixed=False, complete=True)
    return out.transpose(0, 1).reshape(rows.shape[:1] + out.shape[2:])


def window_sums(rows, scalar_limbs, c, lanes=TILE_N, complete=True,
                sub_log2=SUB_LOG2, nbits=SCALAR_BITS, tree=False):
    """Per-window Pippenger sums S_w (W, 3, ncomp, 16): everything but the
    Horner combine. Point sets larger than 2^``sub_log2`` (and a multiple
    of it) run slice by slice, the window sums folded by Jacobian adds.
    ``tree`` accumulates G1 buckets through the affine tree (G2 keeps the
    prefix path, as in the JAX package)."""
    N = rows.shape[0]
    SUB = 1 << sub_log2
    if N > SUB and N % SUB == 0:
        W = n_windows(c, nbits)
        acc = rows.new_zeros((W, 3) + rows.shape[2:])
        for s in range(0, N, SUB):
            Sw = _window_sums_one(rows[s:s + SUB], scalar_limbs[s:s + SUB],
                                  c, lanes, complete, nbits, tree)
            with span("msm.reduce"):
                acc = kernels.addn(acc, Sw)
        return acc
    return _window_sums_one(rows, scalar_limbs, c, lanes, complete, nbits,
                            tree)


def _window_sums_one(rows, scalar_limbs, c, lanes, complete, nbits, tree):
    N, _, ncomp, _ = rows.shape
    if N % lanes or lanes % 32:
        raise ValueError(f"{N} points in {lanes} lanes: lanes must be a "
                         "multiple of 32 that divides the point count")
    k = N // lanes
    W = n_windows(c, nbits)
    half = 1 << (c - 1)
    C, L = _reduction_shape(half)
    dev = rows.device
    pt = (3, ncomp, NLIMB)

    with span("msm.digits"):
        bucket, neg = signed_digits(scalar_limbs, c, nbits)
        # identity inputs (Z = 0) contribute nothing: their digits go to the
        # never-read bucket 0 and a valid curve point stands in for their
        # coordinates, so the mixed-add scan needs no Z plane.
        valid = (rows[:, 2] != 0).reshape(N, -1).any(-1)
        bucket = torch.where(valid[:, None], bucket, 0)
        neg = neg & valid[:, None]
        xy = torch.where(valid[:, None, None, None], rows[:, :2],
                         _safe_point(ncomp, dev))
        xyf = xy.reshape(N, -1)
        # co-sort a packed (index | neg << 31) payload with the bucket keys.
        # K1 reads the row index from its low 31 bits: safe while a slice
        # holds at most 2^SUB_LOG2 rows (window_sums cuts larger sets into
        # such slices; the kernels' other offsets are size_t)
        payload = (torch.arange(N, device=dev)[:, None]
                   | (neg.long() << 31))                   # (N, W)
        skeys, perm = torch.sort(bucket, dim=0, stable=True)
        svals = torch.gather(payload, 0, perm)

    if tree and ncomp == 1:
        # the batched-affine pairwise tree over the sorted bucket segments
        # (msm/affine_tree.py, kernel K8) replaces the chunk prefix and the
        # boundary differences below. Rows (W, N, 32) per window: x, then y
        # negated where the sign bit is set.
        with span("msm.buckets"):
            xyn = torch.cat([xyf[:, :NLIMB], FP.neg(xyf[:, NLIMB:])], dim=1)
            sv_t = svals.T
            order = sv_t & 0x7FFFFFFF
            neg_w = (sv_t >> 31) != 0
            pts = torch.where(neg_w[..., None], xyn[order], xyf[order])
            B = affine_tree.bucket_sums_tree(pts, skeys.T.contiguous(),
                                             half, complete)
        return _reduce_buckets(B, W, half, C, L)
    if W > 32:
        raise ValueError(f"c={c} gives {W} windows of {nbits} bits; the "
                         "level-1 cross-chunk prefix holds at most 32")
    with span("msm.buckets"):
        # step-major payload: [w, j, l] = sorted position l * k + j of
        # window w
        svals_t = svals.reshape(lanes, k, W).permute(2, 1, 0).contiguous()
        # every window in one K1 launch, its rows gathered in the kernel;
        # the prefix comes back in sorted order (W * N rows)
        prs = kernels.prefix_rows(xy, svals_t, complete).reshape(
            (W * N,) + pt)

        wi = torch.arange(W, device=dev)[:, None]
        last = (torch.arange(lanes, device=dev) + 1) * k - 1
        TOT = prs[(wi * N + last).reshape(-1)]              # (W * lanes,)

        # ---- cross-chunk exclusive prefix of the `lanes` chunk totals,
        # all windows batched into lanes: level 1 groups the chunks of
        # window w into GA groups of 32; flat row (w*GA + g)*32 + e =
        # w*lanes + g*32 + e. K2 runs on the real lanes only: W * GA of 32
        # steps, then W of GA.
        GA = lanes // 32
        l1 = _prefix_chunks(TOT, 32)
        gtot = l1[torch.arange(W * GA, device=dev) * 32 + 31]
        l2 = _prefix_chunks(gtot, GA)

        # excl[w, chunk = g*32 + e] = l1[e-1 @ lane w*GA + g]
        #                              + l2[g-1 @ lane w]
        # (K4 gathers both, the identity where e = 0 or g = 0)
        excl = kernels.addn(l1, l2, *excl_index(W, lanes, dev))

        # ---- E[i] at bucket boundaries; B_j = E[start_{j+1}] - E[start_j]
        # (K4 gathers excl and the prefix rows, zeroes E where the bucket
        # start is 0, and negates E[start_j])
        ex_i, pr_i, zm = boundary_index(skeys, k, lanes, half)
        E = kernels.addn(excl, prs, ex_i, pr_i, zero=zm)
        B = kernels.addn(E, E, *diff_index(W, half, dev), neg_b=True)
    # B[w, j-1] = bucket j's sum, j = 1..half
    return _reduce_buckets(B.reshape((W, half) + pt), W, half, C, L)


def _stream(device):
    """The current stream of a CUDA device (None on the CPU): the index
    caches key on it, since a tensor made on one stream may not be written
    yet when another stream reads it."""
    return (torch.cuda.current_stream(device).cuda_stream
            if device.type == "cuda" else None)


def excl_index(W, lanes, device):
    """K4's (ia, ib) for the cross-chunk exclusive prefix: chunk g*32 + e
    of window w takes row (w*GA + g)*32 + e - 1 of the level-1 prefix and
    row w*GA + g - 1 of the level-2 prefix (GA = lanes / 32), -1 (the
    identity) where e = 0 or g = 0. Made once per shape and stream."""
    return _excl_index(W, lanes, device, _stream(device))


@functools.lru_cache(maxsize=None)
def _excl_index(W, lanes, device, stream):
    GA = lanes // 32
    wi = torch.arange(W, device=device)[:, None]
    ch = torch.arange(lanes, device=device)[None, :]
    g, e = ch // 32, ch % 32
    ia = torch.where(e == 0, -1, (wi * GA + g) * 32 + e - 1)
    ib = torch.where(g == 0, -1, wi * GA + g - 1)
    return ia.reshape(-1), ib.reshape(-1)


def boundary_index(skeys, k, lanes, half):
    """K4's (ia, ib, zero) for the bucket boundaries E[w, v], v = 0 .. half
    + 1, from the sorted bucket keys (N, W): starts[w, v] = #keys < v in
    window w (one batched search, no host sync); E[w, v] = excl at the chunk
    of the sorted position starts - 1 plus the prefix row there (clamped
    into the window), zeros where starts = 0."""
    N, W = skeys.shape
    dev = skeys.device
    nq = half + 2
    starts = torch.searchsorted(
        skeys.T.contiguous(),
        torch.arange(nq, device=dev).expand(W, nq).contiguous())
    wi = torch.arange(W, device=dev)[:, None]
    idx = (starts - 1).clamp(0, N - 1)
    return ((wi * lanes + idx // k).reshape(-1), (wi * N + idx).reshape(-1),
            (starts == 0).reshape(-1))


def diff_index(W, half, device):
    """K4's (ia, ib) for B_j = E[w, j + 1] - E[w, j], j = 1 .. half, over
    E's rows w * (half + 2) + v. Made once per shape and stream."""
    return _diff_index(W, half, device, _stream(device))


@functools.lru_cache(maxsize=None)
def _diff_index(W, half, device, stream):
    j = torch.arange(1, half + 1, device=device)
    base = (torch.arange(W, device=device) * (half + 2))[:, None]
    return (base + j + 1).reshape(-1), (base + j).reshape(-1)


def _reduce_buckets(B, W, half, C, L):
    """Bucket reduction sum_j j B_j per window, j = m L + (l + 1), from the
    dense bucket rows B (W, half, 3, ncomp, 16)."""
    with span("msm.reduce"):
        pt = B.shape[2:]
        Bm = B.reshape((W * C, L) + pt).transpose(0, 1).contiguous()
        T, U = kernels.wsum(Bm)                       # (W*C,) lanes each
        T = T.reshape((W, C) + pt)
        U = U.reshape((W, C) + pt)
        if C > 1:
            # one launch over 2W lanes (T's windows, then U's), steps = C
            acc, tot = kernels.wsum(
                torch.cat([T, U]).transpose(0, 1).contiguous())
            # sum_m m T_m = (sum (m+1) T_m) - (sum T_m)
            mT = kernels.addn(tot[:W], acc[:W], neg_b=True)
            sU = acc[W:]
        else:
            mT = torch.zeros_like(U[:, 0])
            sU = U[:, 0].contiguous()
        # window sums S_w = L * (sum_m m T_m) + sum_m U_m
        return kernels.scale_add(mT, sU, L.bit_length() - 1)


# The MSM is integer work that never needs autograd: inference mode drops
# autograd's bookkeeping from each of its many small ops, which is host time
# on every plain field product. The prover's entry points do the same.
@torch.inference_mode()
def msm_rows(rows, scalar_limbs, c=13, lanes=TILE_N, complete=True,
             nbits=SCALAR_BITS, sub_log2=SUB_LOG2, tree=False):
    """rows int64[N, 3, ncomp, 16] Jacobian Montgomery points with Z in
    {R, 0}; scalar_limbs int64[N, 16] plain. N must be a multiple of
    ``lanes``. Returns the MSM as one point row (3, ncomp, 16)."""
    S = window_sums(rows, scalar_limbs, c, lanes, complete, sub_log2, nbits,
                    tree)
    with span("msm.horner"):
        return kernels.horner(S, c)


def msm_grid_g1(points, scalar_limbs, c: int = 13, lanes: int = TILE_N,
                complete: bool = True, nbits: int = SCALAR_BITS,
                sub_log2: int = SUB_LOG2, tree: bool = False):
    """Grid-accumulator MSM over G1. points: (X, Y, Z) int64[N, 16]
    Montgomery Jacobian with Z in {R, 0}; scalar_limbs int64[N, 16] plain;
    N a multiple of ``lanes``. Runs on the points' device. Returns (X, Y, Z)
    int64[16] each. ``complete=False`` (prover mode) drops the doubling
    branch of the input-point scan (or, with ``tree``, of the pair adds).
    ``tree`` accumulates the buckets through the batched-affine pairwise
    tree (``msm/affine_tree.py``, kernel K8) instead of the prefix scan."""
    X, Y, Z = points
    with span("msm.stack"):
        rows = torch.stack([X, Y, Z], 1)[:, :, None, :]
    out = msm_rows(rows, scalar_limbs, c, lanes, complete, nbits, sub_log2,
                   tree)
    return out[0, 0], out[1, 0], out[2, 0]


def msm_grid_g2(points, scalar_limbs, c: int = 13, lanes: int = TILE_N,
                complete: bool = True, nbits: int = SCALAR_BITS,
                sub_log2: int = SUB_LOG2, tree: bool = False):
    """Grid-accumulator MSM over G2: points (X, Y, Z) int64[N, 2, 16] (Fp2
    coordinates). Returns (X, Y, Z) int64[2, 16] each. ``tree`` is taken as
    in the JAX package and changes nothing: the affine tree is G1 only, so
    G2 runs the prefix path."""
    X, Y, Z = points
    with span("msm.stack"):
        rows = torch.stack([X, Y, Z], 1)
    out = msm_rows(rows, scalar_limbs, c, lanes, complete, nbits, sub_log2,
                   tree)
    return out[0], out[1], out[2]
