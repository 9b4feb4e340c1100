"""Parser for sunspot/gnark ``.ccs`` constraint-system files.

The port's copy of ``tpu_zkpool/groth16/ccs.py`` (host code): the same
``GnarkCCS`` from the same bytes.

The reference pipeline compiles the Noir withdraw circuit into a gnark
constraint system with ``sunspot compile`` and commits the result as
``noir_circuit/target/shielded_pool_verifier.ccs`` (576 KB; produced by
``noir_circuit/prove_linux.sh:66-79``).  That file is the only ground
truth for what gnark actually proves, so this module deserializes it and
``tests/test_ccs.py`` conformance-checks our own ACIR->R1CS conversion
(``groth16.r1cs.convert``) against it: public-input layout,
variable accounting, and coefficient-table provenance.

Wire format (gnark v0.14.0 ``constraint.System`` serialization,
reverse-engineered from the committed artifact — the header arithmetic,
CBOR boundary, and coefficient encoding below were all verified
byte-for-byte against it):

  offset 0   u64  byte length of everything after the first 32 bytes
  offset 8   u64  gnark version major   (0)
  offset 16  u64  gnark version minor   (14)
  offset 24  u64  gnark version patch   (0)
  offset 32  u64  len(section 1)  -- packed ``Levels``        (opaque)
  offset 40  u64  len(section 2)  -- packed ``Instructions``  (opaque)
  offset 48  u64  len(section 3)  -- packed ``CallData``      (opaque)
  offset 56  u64  len(CBOR body)
  offset 64  the three packed sections, then the CBOR body, then:
  tail       u64 n_coeffs, followed by n_coeffs * 32-byte fr.Elements
             in Montgomery form, little-endian limbs
             (coefficients[0..4] are gnark's canonical 0, 1, 2, -1, -2)

Sections 1/2 (``Levels`` / ``Instructions``) are solver-scheduling
metadata in gnark's block-compressed integer encoding and are left
opaque.  Section 3 (``CallData``) is a stream of LEB128 varints and is
decoded COMPLETELY: it is a sequence of self-delimiting records
``[n, ...n-1 more values]`` where R1C records read
``[n][lenL][lenR][lenO][(coeffID, wireID) x (lenL+lenR+lenO)]``
(n == 4 + 2*terms) and hint records read ``[n][hintID][...]`` (hintID
matches a key of ``MHintsDependencies``).  On the committed file the
walk yields exactly ``NbConstraints`` R1C records + 41 hint records
covering every one of the 262,332 calldata values — so
``GnarkCCS.constraints`` exposes gnark's actual R1CS rows, wire IDs in
gnark's [public | secret | internal] wire space and coefficient IDs
into the decoded table.  The CBOR body is decoded with the minimal
RFC 8949 reader below; the decoder errors loudly on anything it does
not recognize.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_R_INV = pow(1 << 256, -1, FR_MOD)

# gnark constraint.SystemType (constraint/core.go): 1 = R1CS, 2 = SparseR1CS.
SYSTEM_R1CS = 1
SYSTEM_SPARSE_R1CS = 2


# --------------------------------------------------------------------- CBOR

def _cbor_decode(b: bytes, o: int = 0):
    """Decode one CBOR item at offset ``o``; return (value, next_offset)."""
    ib = b[o]
    o += 1
    mt, ai = ib >> 5, ib & 0x1F
    if ai < 24:
        arg = ai
    elif ai == 24:
        arg = b[o]
        o += 1
    elif ai == 25:
        arg = int.from_bytes(b[o:o + 2], "big")
        o += 2
    elif ai == 26:
        arg = int.from_bytes(b[o:o + 4], "big")
        o += 4
    elif ai == 27:
        arg = int.from_bytes(b[o:o + 8], "big")
        o += 8
    elif ai == 31:
        arg = None  # indefinite length
    else:
        raise ValueError(f"cbor: reserved additional-info {ai} at {o - 1}")

    if mt == 0:
        return arg, o
    if mt == 1:
        return -1 - arg, o
    if mt == 2:
        return b[o:o + arg], o + arg
    if mt == 3:
        return b[o:o + arg].decode("utf8"), o + arg
    if mt == 4:
        out = []
        if arg is None:
            while b[o] != 0xFF:
                v, o = _cbor_decode(b, o)
                out.append(v)
            return out, o + 1
        for _ in range(arg):
            v, o = _cbor_decode(b, o)
            out.append(v)
        return out, o
    if mt == 5:
        m = {}
        if arg is None:
            while b[o] != 0xFF:
                k, o = _cbor_decode(b, o)
                v, o = _cbor_decode(b, o)
                m[k] = v
            return m, o + 1
        for _ in range(arg):
            k, o = _cbor_decode(b, o)
            v, o = _cbor_decode(b, o)
            m[k] = v
        return m, o
    if mt == 6:  # tag: keep (tag, value) so blueprint type tags survive
        v, o = _cbor_decode(b, o)
        return CborTag(arg, v), o
    # mt == 7: simple values gnark emits (false/true/null)
    if ai == 20:
        return False, o
    if ai == 21:
        return True, o
    if ai in (22, 23):
        return None, o
    raise ValueError(f"cbor: unsupported simple value {ai} at {o - 1}")


@dataclass(frozen=True)
class CborTag:
    tag: int
    value: object


def _untag(x):
    return x.value if isinstance(x, CborTag) else x


# ------------------------------------------------------------------- parser

@dataclass
class R1CRow:
    """One gnark R1C: L * R == O, each a list of (coeff_id, wire_id)."""

    L: list
    R: list
    O: list


@dataclass
class HintCall:
    """One solver hint instruction recorded in the calldata stream."""

    hint_id: int
    calldata: list  # raw values after [n, hintID]


@dataclass
class GnarkCCS:
    """The conformance-relevant content of a gnark ``.ccs`` file."""

    gnark_version: str
    system_type: int                 # SYSTEM_R1CS / SYSTEM_SPARSE_R1CS
    scalar_field: int                # modulus the system is defined over
    nb_constraints: int
    nb_internal_variables: int
    public: list = field(default_factory=list)   # names; public[0] == "1"
    secret: list = field(default_factory=list)   # names
    commitments: list = field(default_factory=list)  # raw CBOR maps
    hints: dict = field(default_factory=dict)    # hint id -> import path
    blueprint_tags: list = field(default_factory=list)
    coefficients: list = field(default_factory=list)  # canonical ints < r
    constraints: list = field(default_factory=list)   # [R1CRow]
    hint_calls: list = field(default_factory=list)    # [HintCall]
    schedule: list = field(default_factory=list)      # [("r1c"|"hint", idx)]
    section_lens: tuple = (0, 0, 0, 0)  # levels, instructions, calldata, cbor

    @property
    def nb_public(self) -> int:
        return len(self.public)

    @property
    def nb_variables(self) -> int:
        """Total wire count: public (incl. the ONE wire) + secret + internal."""
        return len(self.public) + len(self.secret) + self.nb_internal_variables


def load(path: str) -> GnarkCCS:
    with open(path, "rb") as f:
        data = f.read()
    return parse(data)


def _decode_varints(buf: bytes) -> list:
    vals = []
    o, n = 0, len(buf)
    while o < n:
        v, shift = 0, 0
        while True:
            b = buf[o]
            o += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        vals.append(v)
    return vals


def _decode_calldata(section: bytes, hint_ids) -> tuple:
    """Walk the self-delimiting calldata records into R1C rows + hints."""
    (n_values,) = struct.unpack("<Q", section[:8])
    vals = _decode_varints(section[8:])
    if len(vals) != n_values:
        raise ValueError(f"ccs: calldata decoded {len(vals)} != {n_values}")
    rows, hints, schedule = [], [], []
    i = 0
    while i < len(vals):
        n = vals[i]
        if n < 2 or i + n > len(vals):
            raise ValueError(f"ccs: bad calldata record at {i} (n={n})")
        rec = vals[i:i + n]
        i += n
        if (n >= 4 and n == 4 + 2 * (rec[1] + rec[2] + rec[3])
                and rec[1] + rec[2] + rec[3] > 0):
            lL, lR, lO = rec[1], rec[2], rec[3]
            terms = [(rec[4 + 2 * k], rec[5 + 2 * k]) for k in range(lL + lR + lO)]
            schedule.append(("r1c", len(rows)))
            rows.append(R1CRow(L=terms[:lL], R=terms[lL:lL + lR],
                               O=terms[lL + lR:]))
        elif rec[1] in hint_ids:
            schedule.append(("hint", len(hints)))
            hints.append(HintCall(hint_id=rec[1], calldata=rec[2:]))
        else:
            raise ValueError(
                f"ccs: record at {i - n} is neither R1C-shaped nor a known "
                f"hint (head {rec[:6]})")
    return rows, hints, schedule


def parse(data: bytes) -> GnarkCCS:
    if len(data) < 64:
        raise ValueError("ccs: file shorter than the 64-byte header")
    (total_after_32, ver_maj, ver_min, ver_patch,
     levels_len, instr_len, calldata_len, cbor_len) = struct.unpack(
        "<8Q", data[:64])
    if total_after_32 != len(data) - 32:
        raise ValueError(
            f"ccs: header length field {total_after_32} != {len(data) - 32}")
    body_off = 64 + levels_len + instr_len + calldata_len
    body = data[body_off:body_off + cbor_len]
    obj, consumed = _cbor_decode(body, 0)
    if consumed != len(body):
        raise ValueError(f"ccs: cbor body has {len(body) - consumed} trailing bytes")

    # Coefficient table: u64 count + raw fr.Elements (Montgomery, LE limbs).
    coeff_off = body_off + cbor_len
    (n_coeffs,) = struct.unpack("<Q", data[coeff_off:coeff_off + 8])
    raw = data[coeff_off + 8:]
    if len(raw) != 32 * n_coeffs:
        raise ValueError(
            f"ccs: coefficient tail is {len(raw)} bytes, want {32 * n_coeffs}")
    coeffs = [
        (int.from_bytes(raw[i * 32:(i + 1) * 32], "little") * _R_INV) % FR_MOD
        for i in range(n_coeffs)
    ]

    hints = dict(obj.get("MHintsDependencies") or {})
    calldata_off = 64 + levels_len + instr_len
    rows, hint_calls, schedule = _decode_calldata(
        data[calldata_off:calldata_off + calldata_len], set(hints))
    if len(rows) != obj["NbConstraints"]:
        raise ValueError(
            f"ccs: decoded {len(rows)} R1C rows != NbConstraints "
            f"{obj['NbConstraints']}")

    commitments = _untag(obj.get("CommitmentInfo")) or []
    blueprints = obj.get("Blueprints") or []
    return GnarkCCS(
        gnark_version=obj.get("GnarkVersion", f"{ver_maj}.{ver_min}.{ver_patch}"),
        system_type=obj["Type"],
        scalar_field=int(obj["ScalarField"], 16),
        nb_constraints=obj["NbConstraints"],
        nb_internal_variables=obj["NbInternalVariables"],
        public=obj.get("Public") or [],
        secret=obj.get("Secret") or [],
        commitments=[_untag(c) for c in commitments],
        hints=hints,
        blueprint_tags=[b.tag for b in blueprints if isinstance(b, CborTag)],
        coefficients=coeffs,
        constraints=rows,
        hint_calls=hint_calls,
        schedule=schedule,
        section_lens=(levels_len, instr_len, calldata_len, cbor_len),
    )
