"""snarkjs binary container formats: .zkey (Groth16 proving key) and .ptau.

The upstream trusted-setup pipeline (circuit/circuit-compiler.sh) emits
snarkjs artifacts; this module reads and writes the same binary container
so externally-produced proving keys can be ingested and the native
dev-setup keys can be exported.  Pure Python on ops/ec and ops/ff: nothing
here touches a tensor or a device.

Container layout (snarkjs binfile): magic[4] | version u32 | nSections u32,
then per section: sectionType u32 | sectionSize u64 | payload.  All integers
little-endian; field elements are little-endian byte strings in Montgomery
form; G1 points are (x, y) coordinate pairs, G2 points are (x0, x1, y0, y1)
over Fq2.

Groth16 .zkey sections: 1 prover-type, 2 header (q, r, nVars, nPublic,
domainSize, alpha/beta/gamma/delta points), 3 IC, 4 coefficient map,
5 A points, 6 B1, 7 B2, 8 C, 9 H.

The coefficient section maps (matrix, constraint, signal) to coefficients
in the *producer's* witness ordering; utils/zkey_compat.py adapts between
producer orderings (e.g. circom's component-instantiation numbering) and
this framework's canonical layout, and turns a parsed zkey into prover
inputs (pk_from_zkey / arrays_from_zkey).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

from ..ops import ff

N8Q = 32
N8R = 32
R_MONT_Q = (1 << 256) % ff.P_FQ
R_MONT_R = (1 << 256) % ff.P_FR
R_INV_Q = pow(R_MONT_Q, -1, ff.P_FQ)
R_INV_R = pow(R_MONT_R, -1, ff.P_FR)


def _fq_to_mont_bytes(x: int) -> bytes:
    return (x * R_MONT_Q % ff.P_FQ).to_bytes(N8Q, "little")


def _fq_from_mont_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little") * R_INV_Q % ff.P_FQ


def _fr_to_mont_bytes(x: int) -> bytes:
    return (x * R_MONT_R % ff.P_FR).to_bytes(N8R, "little")


def _fr_from_mont_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little") * R_INV_R % ff.P_FR


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * (2 * N8Q)
    return _fq_to_mont_bytes(pt[0]) + _fq_to_mont_bytes(pt[1])


def _g1_parse(b: bytes):
    x = _fq_from_mont_bytes(b[:N8Q])
    y = _fq_from_mont_bytes(b[N8Q:2 * N8Q])
    if x == 0 and y == 0:
        return None
    return (x, y)


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * (4 * N8Q)
    (x0, x1), (y0, y1) = pt
    return (_fq_to_mont_bytes(x0) + _fq_to_mont_bytes(x1)
            + _fq_to_mont_bytes(y0) + _fq_to_mont_bytes(y1))


def _g2_parse(b: bytes):
    x0 = _fq_from_mont_bytes(b[:N8Q])
    x1 = _fq_from_mont_bytes(b[N8Q:2 * N8Q])
    y0 = _fq_from_mont_bytes(b[2 * N8Q:3 * N8Q])
    y1 = _fq_from_mont_bytes(b[3 * N8Q:4 * N8Q])
    if x0 == x1 == y0 == y1 == 0:
        return None
    return ((x0, x1), (y0, y1))


class _BinWriter:
    def __init__(self, magic: bytes, version: int = 1):
        assert len(magic) == 4
        self.buf = io.BytesIO()
        self.magic = magic
        self.version = version
        self.sections: list[tuple[int, bytes]] = []

    def add_section(self, stype: int, payload: bytes) -> None:
        self.sections.append((stype, payload))

    def tobytes(self) -> bytes:
        out = io.BytesIO()
        out.write(self.magic)
        out.write(struct.pack("<II", self.version, len(self.sections)))
        for stype, payload in self.sections:
            out.write(struct.pack("<IQ", stype, len(payload)))
            out.write(payload)
        return out.getvalue()


class _BinReader:
    def __init__(self, data: bytes, magic: bytes):
        assert data[:4] == magic, f"bad magic: {data[:4]!r} != {magic!r}"
        self.version, n_sections = struct.unpack_from("<II", data, 4)
        self.sections: dict[int, bytes] = {}
        off = 12
        for _ in range(n_sections):
            stype, size = struct.unpack_from("<IQ", data, off)
            off += 12
            self.sections[stype] = data[off:off + size]
            off += size


@dataclass
class ZkeyData:
    """Parsed Groth16 zkey contents (affine plain-form points)."""
    n_vars: int
    n_public: int
    domain: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    ic: list
    coeffs: list = field(default_factory=list)  # (matrix, row, signal, value)
    a_g1: list = field(default_factory=list)
    b_g1: list = field(default_factory=list)
    b_g2: list = field(default_factory=list)
    c_g1: list = field(default_factory=list)
    h_g1: list = field(default_factory=list)


def write_zkey(z: ZkeyData) -> bytes:
    w = _BinWriter(b"zkey")
    w.add_section(1, struct.pack("<I", 1))  # groth16
    hdr = io.BytesIO()
    hdr.write(struct.pack("<I", N8Q))
    hdr.write(ff.P_FQ.to_bytes(N8Q, "little"))
    hdr.write(struct.pack("<I", N8R))
    hdr.write(ff.P_FR.to_bytes(N8R, "little"))
    hdr.write(struct.pack("<III", z.n_vars, z.n_public, z.domain))
    hdr.write(_g1_bytes(z.alpha_g1))
    hdr.write(_g1_bytes(z.beta_g1))
    hdr.write(_g2_bytes(z.beta_g2))
    hdr.write(_g2_bytes(z.gamma_g2))
    hdr.write(_g1_bytes(z.delta_g1))
    hdr.write(_g2_bytes(z.delta_g2))
    w.add_section(2, hdr.getvalue())
    w.add_section(3, b"".join(_g1_bytes(p) for p in z.ic))
    cf = io.BytesIO()
    cf.write(struct.pack("<I", len(z.coeffs)))
    for mat, row, sig, val in z.coeffs:
        cf.write(struct.pack("<III", mat, row, sig))
        cf.write(_fr_to_mont_bytes(val))
    w.add_section(4, cf.getvalue())
    w.add_section(5, b"".join(_g1_bytes(p) for p in z.a_g1))
    w.add_section(6, b"".join(_g1_bytes(p) for p in z.b_g1))
    w.add_section(7, b"".join(_g2_bytes(p) for p in z.b_g2))
    w.add_section(8, b"".join(_g1_bytes(p) for p in z.c_g1))
    w.add_section(9, b"".join(_g1_bytes(p) for p in z.h_g1))
    return w.tobytes()


def read_zkey(data: bytes) -> ZkeyData:
    r = _BinReader(data, b"zkey")
    (prover_type,) = struct.unpack_from("<I", r.sections[1], 0)
    assert prover_type == 1, "only groth16 zkeys supported"
    h = r.sections[2]
    off = 0
    (n8q,) = struct.unpack_from("<I", h, off); off += 4
    q = int.from_bytes(h[off:off + n8q], "little"); off += n8q
    assert q == ff.P_FQ, "zkey curve is not bn128"
    (n8r,) = struct.unpack_from("<I", h, off); off += 4
    rr = int.from_bytes(h[off:off + n8r], "little"); off += n8r
    assert rr == ff.P_FR
    n_vars, n_public, domain = struct.unpack_from("<III", h, off); off += 12
    alpha = _g1_parse(h[off:off + 2 * N8Q]); off += 2 * N8Q
    beta1 = _g1_parse(h[off:off + 2 * N8Q]); off += 2 * N8Q
    beta2 = _g2_parse(h[off:off + 4 * N8Q]); off += 4 * N8Q
    gamma2 = _g2_parse(h[off:off + 4 * N8Q]); off += 4 * N8Q
    delta1 = _g1_parse(h[off:off + 2 * N8Q]); off += 2 * N8Q
    delta2 = _g2_parse(h[off:off + 4 * N8Q]); off += 4 * N8Q

    def g1_list(b: bytes):
        return [_g1_parse(b[i:i + 2 * N8Q]) for i in range(0, len(b), 2 * N8Q)]

    def g2_list(b: bytes):
        return [_g2_parse(b[i:i + 4 * N8Q]) for i in range(0, len(b), 4 * N8Q)]

    coeffs = []
    cf = r.sections.get(4, b"\x00\x00\x00\x00")
    (n_coef,) = struct.unpack_from("<I", cf, 0)
    off2 = 4
    for _ in range(n_coef):
        mat, row, sig = struct.unpack_from("<III", cf, off2)
        off2 += 12
        val = _fr_from_mont_bytes(cf[off2:off2 + N8R])
        off2 += N8R
        coeffs.append((mat, row, sig, val))

    return ZkeyData(
        n_vars=n_vars, n_public=n_public, domain=domain,
        alpha_g1=alpha, beta_g1=beta1, beta_g2=beta2, gamma_g2=gamma2,
        delta_g1=delta1, delta_g2=delta2,
        ic=g1_list(r.sections[3]),
        coeffs=coeffs,
        a_g1=g1_list(r.sections.get(5, b"")),
        b_g1=g1_list(r.sections.get(6, b"")),
        b_g2=g2_list(r.sections.get(7, b"")),
        c_g1=g1_list(r.sections.get(8, b"")),
        h_g1=g1_list(r.sections.get(9, b"")),
    )


@dataclass
class PtauData:
    power: int
    tau_g1: list
    tau_g2: list
    alpha_tau_g1: list = field(default_factory=list)
    beta_tau_g1: list = field(default_factory=list)
    beta_g2: tuple | None = None


def write_ptau(p: PtauData) -> bytes:
    w = _BinWriter(b"ptau")
    hdr = struct.pack("<I", N8Q) + ff.P_FQ.to_bytes(N8Q, "little") \
        + struct.pack("<II", p.power, p.power)
    w.add_section(1, hdr)
    w.add_section(2, b"".join(_g1_bytes(x) for x in p.tau_g1))
    w.add_section(3, b"".join(_g2_bytes(x) for x in p.tau_g2))
    w.add_section(4, b"".join(_g1_bytes(x) for x in p.alpha_tau_g1))
    w.add_section(5, b"".join(_g1_bytes(x) for x in p.beta_tau_g1))
    w.add_section(6, _g2_bytes(p.beta_g2))
    return w.tobytes()


def read_ptau(data: bytes) -> PtauData:
    r = _BinReader(data, b"ptau")
    h = r.sections[1]
    (n8,) = struct.unpack_from("<I", h, 0)
    q = int.from_bytes(h[4:4 + n8], "little")
    assert q == ff.P_FQ, "ptau curve is not bn128"
    power, _ = struct.unpack_from("<II", h, 4 + n8)

    def g1_list(b):
        return [_g1_parse(b[i:i + 2 * N8Q]) for i in range(0, len(b), 2 * N8Q)]

    def g2_list(b):
        return [_g2_parse(b[i:i + 4 * N8Q]) for i in range(0, len(b), 4 * N8Q)]

    return PtauData(
        power=power,
        tau_g1=g1_list(r.sections.get(2, b"")),
        tau_g2=g2_list(r.sections.get(3, b"")),
        alpha_tau_g1=g1_list(r.sections.get(4, b"")),
        beta_tau_g1=g1_list(r.sections.get(5, b"")),
        beta_g2=_g2_parse(r.sections.get(6, b"\x00" * (4 * N8Q))),
    )
