"""Batched-affine bucket accumulation for the grid MSM (the port of
``tpu_zkpool/msm/affine_tree.py``).

With ``tree=True`` the G1 MSM replaces the chunk-prefix scan and the
boundary differences of ``grid._window_sums_one`` by a segmented pairwise
tree over each window's sorted bucket segments:

- level t pairs adjacent elements with even local index inside their
  bucket segment (the local index halves per level, so a segment of length
  l finishes in ceil(log2 l) levels and the whole tree in T = ceil(log2 n));
- every pair is one affine addition whose lambda denominator is inverted by
  Montgomery's batch trick (kernel K8, ``csrc/affine_tree.cu``, wrapper
  ``msm/tree_kernels.py:tree_level``; plain twin ``tree_level_plain``);
- pass-through elements (odd tails, finished singletons) are gathered into
  the next level without entering the field arithmetic;
- level sizes are host integers from ``tree_plan``'s worst-case bounds, so
  adversarial scalars (all equal: one segment per window) stay correct, and
  the point at infinity travels as a flag plane.

The glue keeps the JAX values with torch idiom: the windows are stacked in
one (W, s_t, 32) tensor and gathered through flat offsets ``w * s_t + i``
(the JAX per-window lists and optimization barriers worked around an
XLA:TPU gather cliff), no level syncs with the host, and the final bucket
extraction counts keys with one ``bincount`` over offset keys.

Rows are ``int64[..., 32]``: 16 Montgomery limbs of x, then 16 of y.
"""

from __future__ import annotations

import torch

from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.fields.limbs import NLIMB
# tree_kernels imports this module for the plain twin; both only use each
# other's names inside functions, so the import cycle is benign.
from tpu_zkpool_torch.msm import tree_kernels

WORDS2 = 2 * NLIMB          # flat affine row: [x limbs | y limbs] (G1)
_PAD_LI = (1 << 30) + 1     # odd -> never a left, never a valid partner

# flag bits of a pair: the left / right operand is the point at infinity
_INF_L = 1
_INF_R = 2


def tree_plan(n: int, half: int):
    """Worst-case level sizes for one window of ``n`` sorted points in
    buckets 0..half.

    Invariant: an original segment of length l holds ceil(l / 2^t)
    elements at level t, so with g = #segments <= min(half+1, n):
      s_t  =  sum ceil(l/2^t)            <= n // 2^t + g        (and <= s_{t-1})
      p_t  =  sum floor(ceil(l/2^t)/2)   <= n // 2^(t+1) + g_t  (and <= s_t // 2)
    where g_t counts segments still pairable at level t (original length
    >= 2^t + 1, so g_t <= n // (2^t + 1)). Returns (sizes, pairs) with
    len(sizes) = T+1, len(pairs) = T, T = ceil(log2 n).
    """
    T = max(1, (n - 1).bit_length())
    g = min(half + 1, n)
    sizes = [n]
    pairs = []
    for t in range(T):
        g_t = min(g, n // ((1 << t) + 1))
        pairs.append(min(sizes[t] // 2, n // (1 << (t + 1)) + g_t))
        sizes.append(min(sizes[t], n // (1 << (t + 1)) + g))
    return sizes, pairs


def tree_level_plain(L, R, fl, complete: bool):
    """K8 twin: one level's pair additions, op for op
    ``tree_level_xla``. L, R int64[M, 32] affine Montgomery rows; fl
    int64[M] with bits (_INF_L, _INF_R). Returns (out int64[M, 32], inf
    int64[M])."""
    xL, yL = L[:, :NLIMB], L[:, NLIMB:]
    xR, yR = R[:, :NLIMB], R[:, NLIMB:]
    infL = (fl & _INF_L) != 0
    infR = (fl & _INF_R) != 0
    fin = ~infL & ~infR
    d = FP.sub(xR, xL)
    xeq = FP.is_zero(d)
    if complete:
        yd = FP.sub(yR, yL)
        yeq = FP.is_zero(yd)
        dbl = xeq & yeq
        den = FP.select(dbl, FP.add(yL, yL), d)
        x2 = FP.mont_sqr(xL)
        num = FP.select(dbl, FP.add(FP.add(x2, x2), x2), yd)
        inf_pair = xeq & ~yeq
    else:
        den = d
        num = FP.sub(yR, yL)
        inf_pair = xeq
    bad = FP.is_zero(den) | infL | infR
    den = FP.select(bad, FP.ones_mont(den.shape[:-1], den.device), den)
    dinv = FP.inv(den)
    lam = FP.mont_mul(num, dinv)
    x3 = FP.sub(FP.sub(FP.mont_sqr(lam), xL), xR)
    y3 = FP.sub(FP.mont_mul(lam, FP.sub(xL, x3)), yL)
    out = torch.cat([x3, y3], dim=-1)
    out = torch.where(infR[:, None], L, out)
    out = torch.where(infL[:, None], R, out)
    inf3 = (infL & infR) | (fin & inf_pair)
    return out, inf3.long()


def _nth_set(flags, count):
    """Positions int64[W, count] of the q-th set flag per row, q = 1..count
    (clamped to the last column where a row has fewer), and the validity
    mask: a batched searchsorted over the inclusive cumsum."""
    W, n = flags.shape
    cum = torch.cumsum(flags.long(), dim=1)
    q = torch.arange(1, count + 1, device=flags.device)
    pos = torch.searchsorted(cum, q.expand(W, count).contiguous(),
                             side="left")
    valid = q[None, :] <= cum[:, -1:]
    return pos.clamp(max=n - 1), valid


def segment_local_index(key):
    """li[w, i] = i - start of i's equal-key run (keys sorted per row)."""
    W, n = key.shape
    col = torch.arange(n, device=key.device).expand(W, n)
    boundary = torch.ones_like(key, dtype=torch.bool)
    boundary[:, 1:] = key[:, 1:] != key[:, :-1]
    seg_start = torch.cummax(torch.where(boundary, col, 0), dim=1).values
    return col - seg_start


def _rows_at(src, idx):
    """src (W, s, ...) gathered per window at idx (W, k) through the flat
    offsets w * s + i -> (W, k, ...)."""
    W, s = src.shape[:2]
    off = torch.arange(W, device=idx.device)[:, None] * s
    return src.reshape((W * s,) + src.shape[2:])[(idx + off).reshape(-1)] \
        .reshape(idx.shape + src.shape[2:])


def bucket_sums_tree(pts, key, half: int, complete: bool):
    """pts int64[W, n, 32] sorted signed affine rows per window; key
    int64[W, n] sorted bucket ids in [0, half]. Returns Jacobian bucket rows
    int64[W, half, 3, 1, 16] with B[w, j-1] = bucket j's sum, Z = R for a
    present bucket and all-zero rows for an absent one (bucket 0, the
    never-read digit-0 segment, is excluded). Each level runs K8 once over
    all windows' pairs."""
    W, n, words2 = pts.shape
    assert words2 == WORDS2
    dev = pts.device
    sizes, pairs = tree_plan(n, half)
    li = segment_local_index(key)
    inf = torch.zeros((W, n), dtype=torch.int64, device=dev)
    pad_li = torch.full((W, 1), _PAD_LI, dtype=torch.int64, device=dev)

    for t, p_t in enumerate(pairs):
        s_t, s_n = sizes[t], sizes[t + 1]
        is_left = (li & 1) == 0
        nxt_li = torch.cat([li[:, 1:], pad_li], dim=1)
        has_p = is_left & (nxt_li == li + 1)

        pairL, pvalid = _nth_set(has_p, p_t)           # (W, p_t)
        out_src, out_valid = _nth_set(is_left, s_n)    # (W, s_n)
        out_pair = torch.gather(has_p, 1, out_src) & out_valid
        out_rank = torch.cumsum(out_pair.long(), dim=1) - 1

        pairR = (pairL + 1).clamp(max=s_t - 1)
        Lr = _rows_at(pts, pairL).reshape(W * p_t, words2)
        Rr = _rows_at(pts, pairR).reshape(W * p_t, words2)
        flr = torch.gather(inf, 1, pairL) | (torch.gather(inf, 1, pairR) << 1)
        flr = torch.where(pvalid, flr, _INF_L | _INF_R).reshape(-1)
        added, inf3 = tree_kernels.tree_level(Lr, Rr, flr.contiguous(),
                                              complete)

        # a valid output slot takes its pair's sum if it opens a pair, else
        # passes its element through; slots past the level's count are pads
        rank_cl = out_rank.clamp(0, p_t - 1)
        frm_pair = _rows_at(added.reshape(W, p_t, words2), rank_cl)
        frm_self = _rows_at(pts, out_src)
        pts = torch.where(out_pair[..., None], frm_pair, frm_self)
        iw = torch.where(out_pair, torch.gather(inf3.reshape(W, p_t), 1,
                                                rank_cl),
                         torch.gather(inf, 1, out_src))
        inf = torch.where(out_valid, iw, 1)
        key = torch.where(out_valid, torch.gather(key, 1, out_src), half + 1)
        li = torch.where(out_valid, torch.gather(li, 1, out_src) >> 1,
                         _PAD_LI)

    # ---- extract B[w, j] for j = 1..half from the singleton segments ----
    sT = sizes[-1]
    nk = half + 2
    kk = key.clamp(max=half + 1) + torch.arange(W, device=dev)[:, None] * nk
    counts = torch.bincount(kk.reshape(-1), minlength=W * nk).reshape(W, nk)
    starts = torch.cumsum(counts, dim=1) - counts     # #keys < j
    pos = starts[:, 1:half + 1].clamp(0, sT - 1)
    present = (counts[:, 1:half + 1] > 0) & (torch.gather(inf, 1, pos) == 0)
    xy = _rows_at(pts, pos).reshape(W, half, 2, 1, NLIMB)
    xy = torch.where(present[..., None, None, None], xy, 0)
    z = torch.where(present[..., None],
                    FP.ones_mont((), dev), 0).reshape(W, half, 1, 1, NLIMB)
    return torch.cat([xy, z], dim=2)                 # (W, half, 3, 1, 16)
