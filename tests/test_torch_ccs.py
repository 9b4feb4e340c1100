"""Port parity: the gnark ``.ccs`` parser and its solver
(``tpu_zkpool_torch.groth16.{ccs,ccs_solve}``) against
``tpu_zkpool.groth16.{ccs,ccs_solve}``.

The reference's committed ``.ccs`` is not in the repository, so the bytes
come from a writer of the layout ``ccs.py``'s docstring fixes: the 64-byte
header, the opaque level and instruction sections, the calldata (a u64
count, then LEB128 varints: R1C records and hint records), the CBOR body
and the Montgomery coefficient tail. The small system below runs every
hint kind the solver dispatches on: InvZeroHint, nBits, DecomposeHint,
countHint, Randomize and the Bsb22 commitment placeholder.

The port's one departure, ``hints.Randomize`` drawn from a generator (the
JAX solver returns 0x5EED), is checked both ways: with a generator that
returns 0x5EED every wire equals JAX's; with the default one only the
randomizer's wire differs, and two solves draw different values.
"""

import random
import struct

import pytest

from tpu_zkpool.groth16 import ccs as jccs
from tpu_zkpool.groth16 import ccs_solve as jcs

from tpu_zkpool_torch.groth16 import ccs, ccs_solve

from acir_cases import norm

R = ccs.FR_MOD
CONST = ccs_solve.CONST

# ---------------------------------------------------------------- writer


def _cbor_head(major, arg):
    if arg < 24:
        return bytes([major << 5 | arg])
    for ai, n in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if arg < 1 << (8 * n):
            return bytes([major << 5 | ai]) + arg.to_bytes(n, "big")
    raise ValueError(arg)


class Indef(list):
    """A CBOR array written with indefinite length."""


class IndefMap(dict):
    """A CBOR map written with indefinite length."""


def cbor(x) -> bytes:
    if x is False:
        return b"\xf4"
    if x is True:
        return b"\xf5"
    if x is None:
        return b"\xf6"
    if isinstance(x, int):
        return _cbor_head(0, x) if x >= 0 else _cbor_head(1, -1 - x)
    if isinstance(x, bytes):
        return _cbor_head(2, len(x)) + x
    if isinstance(x, str):
        b = x.encode()
        return _cbor_head(3, len(b)) + b
    if isinstance(x, Indef):
        return b"\x9f" + b"".join(map(cbor, x)) + b"\xff"
    if isinstance(x, list):
        return _cbor_head(4, len(x)) + b"".join(map(cbor, x))
    if isinstance(x, IndefMap):
        return b"\xbf" + b"".join(cbor(k) + cbor(v)
                                  for k, v in x.items()) + b"\xff"
    if isinstance(x, dict):
        return _cbor_head(5, len(x)) + b"".join(cbor(k) + cbor(v)
                                                for k, v in x.items())
    if isinstance(x, ccs.CborTag):
        return _cbor_head(6, x.tag) + cbor(x.value)
    raise TypeError(type(x))


def leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def calldata(values) -> bytes:
    return struct.pack("<Q", len(values)) + b"".join(map(leb128, values))


def write_ccs(body: dict, records, coeffs, levels=b"\x01\x02\x03",
              instrs=b"\x04\x05") -> bytes:
    cd = calldata([v for rec in records for v in rec])
    cb = cbor(body)
    tail = struct.pack("<Q", len(coeffs)) + b"".join(
        (c * (1 << 256) % R).to_bytes(32, "little") for c in coeffs)
    rest = levels + instrs + cd + cb + tail
    head = struct.pack("<8Q", 32 + len(rest), 0, 14, 0, len(levels),
                       len(instrs), len(cd), len(cb))
    return head + rest


# ---------------------------------------------------------------- a system

COEFFS = [0, 1, 2, R - 1, R - 2, 4, 8, 16, 3, 5]
C0, C1, C2, C4, C8, C16, C3, C5 = 0, 1, 2, 5, 6, 7, 8, 9
HINTS = {
    2_000_000_001: "github.com/consensys/gnark/constraint/solver.InvZeroHint",
    2_000_000_002: "github.com/consensys/gnark/std/math/bits.nBits",
    2_000_000_003: "github.com/consensys/gnark/std/rangecheck.DecomposeHint",
    2_000_000_004: "github.com/consensys/gnark/std/internal/logderivarg."
                   "countHint",
    2_000_000_005: "github.com/consensys/gnark/std/hints.Randomize",
    2_000_000_006: "github.com/consensys/gnark/frontend/cs."
                   "Bsb22CommitmentComputePlaceholder",
}
# wires: 0 one, 1 x (public), 2 y (secret, ACIR witness 1), 3 .. 16 internal
X, Y = 1, 2
RANDOMIZER = 12


def r1c(L, Rr, O):
    terms = [v for t in L + Rr + O for v in t]
    return [4 + len(terms), len(L), len(Rr), len(O)] + terms


def hint(hid, inputs, lo, hi):
    cd = [len(inputs)]
    for lc in inputs:
        cd += [len(lc)] + [v for t in lc for v in t]
    cd += [lo, hi]
    return [2 + len(cd), hid] + cd


def records():
    k = lambda cid: [(cid, CONST)]                      # noqa: E731
    return [
        hint(2_000_000_001, [[(C1, X)]], 3, 4),                 # 1 / x
        r1c([(C1, X)], [(C1, 3)], [(C1, CONST)]),
        hint(2_000_000_002, [[(C1, Y)]], 4, 8),                 # y's bits
        *[r1c([(C1, b)], [(C1, b)], [(C1, b)]) for b in range(4, 8)],
        r1c([(C1, 4), (C2, 5), (C4, 6), (C8, 7)], [(C1, CONST)], [(C1, Y)]),
        hint(2_000_000_003, [k(C8), k(C4), [(C1, X)]], 8, 10),  # x's nibbles
        r1c([(C1, 8), (C16, 9)], [(C1, CONST)], [(C1, X)]),
        hint(2_000_000_004, [k(C2), k(C1), k(C3), k(C5), k(C3), k(C5),
                             k(C3)], 10, 12),                   # counts 2, 1
        r1c([(C1, 10), (C1, 11)], [(C1, CONST)], [(C3, CONST)]),
        hint(2_000_000_005, [], RANDOMIZER, RANDOMIZER + 1),
        r1c([(C0, RANDOMIZER)], [(C1, CONST)], []),
        r1c([(C1, X)], [(C1, 13)], [(C1, Y)]),                  # w13 = y / x
        hint(2_000_000_006, [k(C0), [(C1, Y)], [(C1, 4)]], 14, 15),
        r1c([(C1, 14)], [(C1, CONST)], [(C1, 15)]),             # w15 = w14
        r1c([(C1, 15), (C1, X)], [(C2, CONST)], [(C1, 16)]),    # w16
    ]


N_R1C = 12


def body(nb_constraints=N_R1C):
    return {
        "GnarkVersion": "v0.14.0", "Type": ccs.SYSTEM_R1CS,
        "ScalarField": format(R, "x"), "NbConstraints": nb_constraints,
        "NbInternalVariables": 14, "Public": ["1", "x"],
        "Secret": ["__witness_1"],
        "CommitmentInfo": ccs.CborTag(55799, [
            {"PrivateCommitted": [2, 4], "CommitmentIndex": 14,
             "NbPublicCommitted": 0}]),
        "MHintsDependencies": HINTS,
        "Blueprints": [ccs.CborTag(4, {"a": 1}), ccs.CborTag(7, None)],
    }


def system_bytes(**kw):
    return write_ccs(body(**kw), records(), COEFFS)


def commit(vals):
    return (sum((i + 3) * v for i, v in enumerate(vals)) * 0x1234567) % R


ACIR = {0: 0xC5, 1: 0xB}


class _Fixed:
    def randrange(self, n):
        return 0x5EED % n


# ------------------------------------------------------------------ tests


def test_parse_equals_jax():
    raw = system_bytes()
    got, want = ccs.parse(raw), jccs.parse(raw)
    assert norm(got) == norm(want)
    assert got.nb_constraints == len(got.constraints) == N_R1C
    assert len(got.hint_calls) == 6 and got.nb_variables == 17
    assert got.coefficients == COEFFS
    assert got.blueprint_tags == [4, 7]
    assert got.commitments[0]["PrivateCommitted"] == [2, 4]
    assert [k for k, _ in got.schedule][:3] == ["hint", "r1c", "hint"]
    assert got.section_lens[:2] == (3, 2)


def test_load_reads_a_file(tmp_path):
    path = tmp_path / "s.ccs"
    path.write_bytes(system_bytes())
    assert norm(ccs.load(str(path))) == norm(jccs.load(str(path)))


_ITEMS = [0, 23, 24, 255, 256, 65535, 65536, 1 << 32, (1 << 64) - 1, -1,
          -24, -25, -(1 << 40), b"", b"\x00\xff" * 20, "", "gnark ü",
          [], [1, [2, [3]]], Indef([1, "a", Indef([])]), {},
          {1: "a", "k": [1, None]}, IndefMap({"x": IndefMap({2: True})}),
          ccs.CborTag(4, [1, 2]), ccs.CborTag(55799, {"t": False}), False,
          True, None]


def test_cbor_decode_equals_jax():
    for item in _ITEMS:
        b = cbor(item)
        got, want = ccs._cbor_decode(b, 0), jccs._cbor_decode(b, 0)
        assert norm(got) == norm(want) and got == (item, len(b))
    assert ccs._cbor_decode(b"\xf7", 0) == jccs._cbor_decode(b"\xf7", 0)
    for bad, match in ((b"\x1c", "reserved"), (b"\xf8\x10", "simple")):
        for mod in (ccs, jccs):
            with pytest.raises(ValueError, match=match):
                mod._cbor_decode(bad, 0)


@pytest.mark.parametrize("values,match", [
    ([1, 2, 3], "decoded"), ([1], "bad calldata record"),
    ([4, 9, 9, 9], "neither")])
def test_calldata_errors_raise(values, match):
    section = calldata(values)
    if match == "decoded":
        section = struct.pack("<Q", len(values) + 1) + section[8:]
    for mod in (ccs, jccs):
        with pytest.raises(ValueError, match=match):
            mod._decode_calldata(section, set(HINTS))
    vals = [300, 1 << 35, 0, 127, 128]
    assert ccs._decode_varints(b"".join(map(leb128, vals))) == vals == \
        jccs._decode_varints(b"".join(map(leb128, vals)))


@pytest.mark.parametrize("fault", ["header", "tail", "count"])
def test_malformed_files_raise(fault):
    """A header length that is not the file's, a coefficient tail short of
    its count, a constraint count that is not the calldata's."""
    raw = system_bytes(nb_constraints=N_R1C + (fault == "count"))
    if fault == "header":
        raw += b"\x00"
    elif fault == "tail":
        raw = raw[:-32]
        raw = struct.pack("<Q", len(raw) - 32) + raw[8:]
    match = {"header": "header length", "tail": "coefficient tail",
             "count": "NbConstraints"}[fault]
    for mod in (ccs, jccs):
        with pytest.raises(ValueError, match=match):
            mod.parse(raw)


def _solve(mod, g, **kw):
    s = mod.CcsSolver(g, commit_fn=commit, **kw)
    s.set_inputs(ACIR, g.nb_public)
    s.solve()
    return s


def test_solver_equals_jax():
    raw = system_bytes()
    g, jg = ccs.parse(raw), jccs.parse(raw)
    fixed = _solve(ccs_solve, g, rng=_Fixed())
    want = _solve(jcs, jg)
    assert fixed.w == want.w
    assert fixed.check_all() and want.check_all()
    assert fixed.w[3] == pow(ACIR[0], -1, R)
    assert fixed.w[4:8] == [1, 1, 0, 1] and fixed.w[8:10] == [5, 0xC]
    assert fixed.w[10:12] == [2, 1] and fixed.w[RANDOMIZER] == 0x5EED
    assert fixed.w[14] == commit([ACIR[1], 1])
    assert vars(fixed.stats) == vars(want.stats)
    a, b = _solve(ccs_solve, g), _solve(ccs_solve, g)
    others = [i for i in range(g.nb_variables) if i != RANDOMIZER]
    assert [a.w[i] for i in others] == [want.w[i] for i in others]
    assert a.w[RANDOMIZER] != b.w[RANDOMIZER]
    assert a.check_all()


def test_solver_rejects_a_wrong_witness():
    g, jg = ccs.parse(system_bytes()), jccs.parse(system_bytes())
    s = _solve(ccs_solve, g)
    s.w[X] = (s.w[X] + 1) % R
    with pytest.raises(ccs_solve.CcsSolveError, match="row"):
        s.check_all()
    js = _solve(jcs, jg)
    js.w[X] = (js.w[X] + 1) % R
    with pytest.raises(AssertionError, match="row"):
        js.check_all()


def test_to_r1cs_and_permute_equal_jax():
    raw = system_bytes()
    g, jg = ccs.parse(raw), jccs.parse(raw)
    r1cs, committed, perm = ccs_solve.to_r1cs(g)
    jr1cs, jcommitted, jperm = jcs.to_r1cs(jg)
    assert (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows) == (
        jr1cs.a_rows, jr1cs.b_rows, jr1cs.c_rows)
    assert (r1cs.num_vars, r1cs.num_public) == (jr1cs.num_vars,
                                                jr1cs.num_public) == (17, 3)
    assert committed == jcommitted and perm == jperm and perm[14] == 2
    s = _solve(ccs_solve, g, rng=_Fixed())
    w = ccs_solve.permute_witness(s.w, perm)
    assert w == jcs.permute_witness(_solve(jcs, jg).w, jperm)
    assert r1cs.is_satisfied(w)


def test_glv_and_mul_hint_equal_jax():
    assert ccs_solve.glv_lambda() == jcs.glv_lambda()
    lam, r = ccs_solve.glv_lambda(), ccs_solve.GRUMPKIN_R
    rng = random.Random(31)
    for s in [0, 1, (1 << 127) - 1, 1 << 127, r - 1] + [
            rng.randrange(r) for _ in range(6)]:
        got = ccs_solve.split_scalar_glv(s, lam, r)
        assert got == jcs.split_scalar_glv(s, lam, r)
        s1, s2 = got
        assert (s + lam * s2 - s1) % r == 0 and max(s1, s2) < 1 << 127
    # emulated.mulHint on e = r * b (8 limbs of 64 bits, modulus r in 4):
    # the quotient's limbs, 4 remainder limbs, the carry polynomial
    def limbs(v, n):
        return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]
    b = rng.randrange(1 << 200)
    table = [0, 1, 2, R - 1, R - 2, 64, 4, 8, 4] + limbs(r, 4) + limbs(
        r * b, 8)
    inputs = [[(5 + i, CONST)] for i in range(4 + 4 + 8)]
    outs = []
    for cmod, smod in ((ccs, ccs_solve), (jccs, jcs)):
        g = cmod.parse(system_bytes())
        g.coefficients = table
        outs.append(smod.CcsSolver(g)._mul_hint(inputs, 4 + 4 + 7))
    assert outs[0] == outs[1]
    assert outs[0][:4] == limbs(b, 4) and outs[0][4:8] == [0] * 4
    assert any(outs[0][8:])
