"""Pure-Python Groth16 setup and verify over BN254 (host code).

The port's copy of the setup/verify half of ``tpu_zkpool.refimpl.groth16_ref``
(the device prover is ``tpu_zkpool_torch.groth16.prove``).

Groth16 recap (notation follows the paper):
  QAP: (A·w) ∘ (B·w) = (C·w) over a multiplicative domain of size n,
  u_i/v_i/w_i the variable polynomials, t(X) = X^n - 1.
  Proof: A = [alpha + U(tau) + r*delta]_1, B = [beta + V(tau) + s*delta]_2,
  C = [ (sum_priv w_i K_i + H(tau)t(tau))/delta + sA + rB1 - rs*delta ]_1.
  Verify: e(A, B) == e(alpha,beta) * e(PUB, gamma) * e(C, delta).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R, G1_GX, G1_GY
from tpu_zkpool_torch.refimpl import pairing_ref as pr

G1_GEN = (G1_GX, G1_GY)
G2_GEN = pr.G2_GEN


# ------------------------------------------------------------------ Fr FFT

def _fr_root(n: int) -> int:
    # Fr - 1 = 2^28 * odd; 5 generates the multiplicative group.
    assert n & (n - 1) == 0 and n <= 1 << 28
    return pow(5, (R - 1) // n, R)


def fr_fft(coeffs: list, invert: bool = False) -> list:
    n = len(coeffs)
    if n == 1:
        return list(coeffs)
    w = _fr_root(n)
    if invert:
        w = pow(w, -1, R)
    even = fr_fft(coeffs[0::2], invert)
    odd = fr_fft(coeffs[1::2], invert)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % R
        out[k] = (even[k] + t) % R
        out[k + n // 2] = (even[k] - t) % R
        wk = wk * w % R
    return out


def fr_ifft(evals: list) -> list:
    n = len(evals)
    inv_n = pow(n, -1, R)
    return [v * inv_n % R for v in fr_fft(evals, invert=True)]


def powers(base: int, count: int, first: int = 1) -> list:
    """[first * base^i mod R for i < count], by a running product."""
    out = [0] * count
    acc = first % R
    for i in range(count):
        out[i] = acc
        acc = acc * base % R
    return out


def _batch_inv(vals: list) -> list:
    """Inverses mod R of non-zero values: one modular inverse and three
    products a value (Montgomery's trick)."""
    pre = [0] * len(vals)
    acc = 1
    for i, v in enumerate(vals):
        pre[i] = acc
        acc = acc * v % R
    inv = pow(acc, -1, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pre[i] * inv % R
        inv = inv * vals[i] % R
    return out


# ------------------------------------------------------------------ R1CS

@dataclass
class R1CS:
    """Constraints as sparse rows {var_index: coeff}; w[0] = 1 constant.

    Variables: [1, public..., private...]. ``num_public`` counts the constant
    slot plus the public inputs.
    """

    num_vars: int
    num_public: int
    a_rows: list
    b_rows: list
    c_rows: list

    def eval_row(self, row: dict, w: list) -> int:
        return sum(c * w[i] for i, c in row.items()) % R

    def is_satisfied(self, w: list) -> bool:
        for a, b, c in zip(self.a_rows, self.b_rows, self.c_rows):
            if self.eval_row(a, w) * self.eval_row(b, w) % R != self.eval_row(c, w):
                return False
        return True


# ------------------------------------------------------------------ setup

@dataclass
class ProvingKey:
    n_domain: int
    alpha1: tuple
    beta1: tuple
    delta1: tuple
    beta2: tuple
    delta2: tuple
    a_query: list      # [u_i(tau)]_1
    b1_query: list     # [v_i(tau)]_1
    b2_query: list     # [v_i(tau)]_2
    k_query: list      # [(beta u_i + alpha v_i + w_i)/delta]_1, private i
    h_query: list      # [tau^i t(tau)/delta]_1
    # gnark-style Pedersen commitment extension (None when unused):
    committed: tuple = ()          # committed private wire indices (sorted)
    basis: tuple = ()              # [( . )/gamma]_1 per committed wire
    basis_exp_sigma: tuple = ()    # sigma * basis


@dataclass
class VerifyingKey:
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    gamma_abc: list    # [(beta u_i + alpha v_i + w_i)/gamma]_1, public i
    commitment_key: tuple | None = None   # (G g2, GSigmaNeg g2)
    committed: tuple = ()                 # committed private wire indices


def setup(r1cs: R1CS, seed: int = 1337, committed=()) -> tuple:
    """``committed``: private wire indices bound by a gnark-style Pedersen
    commitment instead of the delta leg (their basis points move to the
    gamma leg and the commitment's hash-to-field becomes an extra public
    input — the committed VKs' layout, ``groth16/gnark_fmt.py``). The
    commitment-hash wire must be the LAST declared public input."""
    rng = random.Random(seed)
    tau, alpha, beta, gamma, delta = (rng.randrange(1, R) for _ in range(5))
    committed = tuple(sorted(committed))

    m = len(r1cs.a_rows)
    n = 1
    while n < m:
        n <<= 1
    omega = _fr_root(n)

    # Lagrange values L_c(tau) = t(tau) w^c / (n (tau - w^c)) for the m
    # constraints c (rows past m are zero); the inverses by one batch
    # inversion.
    t_tau = (pow(tau, n, R) - 1) % R
    assert t_tau != 0, "tau hit the domain (resample seed)"
    inv_n = pow(n, -1, R)
    ws = powers(omega, m)
    scale = t_tau * inv_n % R
    lag = [scale * wc % R * iv % R
           for wc, iv in zip(ws, _batch_inv([(tau - wc) % R for wc in ws]))]
    del ws

    nv = r1cs.num_vars
    u = [0] * nv
    v = [0] * nv
    w = [0] * nv
    for c in range(m):
        lc = lag[c]
        for i, coef in r1cs.a_rows[c].items():
            u[i] = (u[i] + coef * lc) % R
        for i, coef in r1cs.b_rows[c].items():
            v[i] = (v[i] + coef * lc) % R
        for i, coef in r1cs.c_rows[c].items():
            w[i] = (w[i] + coef * lc) % R

    inv_delta = pow(delta, -1, R)
    inv_gamma = pow(gamma, -1, R)

    # Fixed-base generator multiplications through the native C++ batch
    # path (tens of thousands of them at withdraw scale).
    from tpu_zkpool_torch import native_bridge as nb
    g1_batch, g2_batch = nb.g1_gen_mul_batch, nb.g2_gen_mul_batch

    cset = set(committed)
    assert all(r1cs.num_public <= i < nv for i in committed)
    priv_idx = [i for i in range(r1cs.num_public, nv) if i not in cset]
    k_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) * inv_delta % R
        for i in priv_idx
    ]
    basis_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) * inv_gamma % R
        for i in committed
    ]
    sigma = rng.randrange(1, R)
    g2r = rng.randrange(1, R)
    h_scalars = powers(tau, n - 1, t_tau * inv_delta % R)
    abc_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) * inv_gamma % R
        for i in range(r1cs.num_public)
    ]
    basis_sigma_scalars = [b * sigma % R for b in basis_scalars]
    flat = ([alpha, beta, delta] + [ui % R for ui in u] + [vi % R for vi in v]
            + k_scalars + h_scalars + abc_scalars
            + basis_scalars + basis_sigma_scalars)
    g1s = g1_batch(flat)
    g2s = g2_batch([beta, delta, gamma] + [vi % R for vi in v]
                   + [g2r, (R - sigma * g2r) % R])
    o = 3
    a_query = g1s[o : o + nv]
    b1_query = g1s[o + nv : o + 2 * nv]
    o2 = o + 2 * nv
    k_query = g1s[o2 : o2 + len(k_scalars)]
    o2 += len(k_scalars)
    h_query = g1s[o2 : o2 + len(h_scalars)]
    o2 += len(h_scalars)
    gamma_abc = g1s[o2 : o2 + len(abc_scalars)]
    o2 += len(abc_scalars)
    basis = tuple(g1s[o2 : o2 + len(basis_scalars)])
    o2 += len(basis_scalars)
    basis_sigma = tuple(g1s[o2 : o2 + len(basis_sigma_scalars)])

    pk = ProvingKey(
        n_domain=n,
        alpha1=g1s[0], beta1=g1s[1], delta1=g1s[2],
        beta2=g2s[0], delta2=g2s[1],
        a_query=a_query, b1_query=b1_query, b2_query=g2s[3 : 3 + nv],
        k_query=k_query, h_query=h_query,
        committed=committed, basis=basis, basis_exp_sigma=basis_sigma,
    )
    vk = VerifyingKey(
        alpha1=g1s[0], beta2=g2s[0], gamma2=g2s[2], delta2=g2s[1],
        gamma_abc=gamma_abc,
        commitment_key=(g2s[3 + nv], g2s[4 + nv]) if committed else None,
        committed=committed,
    )
    return pk, vk


# ------------------------------------------------------------------ verify

def verify(vk: VerifyingKey, proof: tuple, public_inputs: list) -> bool:
    """Groth16 verify incl. the gnark commitment extension: when the VK
    carries committed wires, the proof must supply (Commitment, Pok); the
    verifier derives the commitment's hash-to-field as the final public
    input, folds the commitment into the gamma leg, and checks the
    proof-of-knowledge pairing (matching the committed verifier programs,
    ``withdraw.rs:163-175`` / ``gnark_fmt.py`` layouts)."""
    from tpu_zkpool_torch.refimpl import pedersen
    cm = pok = None
    if len(proof) == 5:
        A, B2, C, cm, pok = proof
    else:
        A, B2, C = proof
    if getattr(vk, "committed", ()) and cm is None:
        return False  # commitment required by this VK
    pubs = list(public_inputs)
    if cm is not None:
        if not pedersen.verify_pok(cm, pok, vk.commitment_key):
            return False
        pubs.append(pedersen.commitment_to_field(cm))
    acc = vk.gamma_abc[0]
    for pi, pnt in zip(pubs, vk.gamma_abc[1:]):
        acc = pr.g1_add(acc, pr.g1_mul(pi % R, pnt) if pi % R else None)
    if cm is not None:
        acc = pr.g1_add(acc, cm)
    lhs = pr.pairing(A, B2)
    rhs = pr.pairing(vk.alpha1, vk.beta2)
    rhs = pr.f12_mul(rhs, pr.pairing(acc, vk.gamma2))
    rhs = pr.f12_mul(rhs, pr.pairing(C, vk.delta2))
    return lhs == rhs
