"""Ethereum-style account fixtures: keccak-256, secp256k1, personal_sign.

Host-only helpers replacing dvote's crypto/ethereum usage in the reference
mock-input generator (upstream internal/inputs.go:36-40,55,76):
keypair generation, address derivation (keccak256(pubkey)[12:]), and
deterministic RFC6979 ECDSA signatures over personal_sign-prefixed messages.

The circuit never verifies the ECDSA signature — it is an opaque private
field element (truncated to 64 bytes then reduced mod r, mirroring
upstream ts_inputs/src/inputs.ts:6-13) — so the exact signed message
only matters for reproducing a given wallet's SIK, not for proof validity.
The default message is configurable.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets

# ---------------------------------------------------------------------------
# keccak-256 (original Keccak padding 0x01, not NIST SHA-3)
# ---------------------------------------------------------------------------

_KECCAK_ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
_M64 = (1 << 64) - 1


def _rol(x: int, s: int) -> int:
    return ((x << s) | (x >> (64 - s))) & _M64


def _keccak_f(st: list[int]) -> list[int]:
    for rnd in range(_KECCAK_ROUNDS):
        # theta
        c = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        st = [st[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(st[x + 5 * y],
                                                        _ROT[x][y])
        # chi
        st2 = [0] * 25
        for x in range(5):
            for y in range(5):
                st2[x + 5 * y] = (b[x + 5 * y]
                                  ^ ((~b[(x + 1) % 5 + 5 * y] & _M64)
                                     & b[(x + 2) % 5 + 5 * y]))
        st = st2
        # iota
        st[0] ^= _RC[rnd]
    return st


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    st = [0] * 25
    # pad: 0x01 ... 0x80
    padded = data + b"\x01" + b"\x00" * ((-len(data) - 2) % rate) + b"\x80"
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            st[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        st = _keccak_f(st)
    out = b"".join(st[i].to_bytes(8, "little") for i in range(4))
    return out


# ---------------------------------------------------------------------------
# secp256k1
# ---------------------------------------------------------------------------

SECP_P = 2**256 - 2**32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
          0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


def _ec_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0] and (a[1] + b[1]) % SECP_P == 0:
        return None
    if a == b:
        lam = (3 * a[0] * a[0]) * pow(2 * a[1], -1, SECP_P) % SECP_P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, SECP_P) % SECP_P
    x = (lam * lam - a[0] - b[0]) % SECP_P
    y = (lam * (a[0] - x) - a[1]) % SECP_P
    return (x, y)


def _ec_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _ec_add(acc, pt)
        pt = _ec_add(pt, pt)
        k >>= 1
    return acc


DEFAULT_SIK_MESSAGE = (
    b"This signature approves the proof of SIK for the Vocdoni protocol"
)


class Account:
    """secp256k1 account with Ethereum address + personal_sign."""

    def __init__(self, priv: int | None = None):
        self.priv = priv if priv is not None else secrets.randbelow(SECP_N - 1) + 1
        self.pub = _ec_mul(self.priv, SECP_G)

    @property
    def address(self) -> bytes:
        px, py = self.pub
        pub_bytes = px.to_bytes(32, "big") + py.to_bytes(32, "big")
        return keccak256(pub_bytes)[12:]

    def _sign_digest(self, digest: bytes) -> bytes:
        """Deterministic ECDSA (RFC 6979, HMAC-SHA256), low-s, 65 bytes
        r||s||v (v in {0,1}) like go-ethereum's Sign."""
        z = int.from_bytes(digest, "big") % SECP_N
        x = self.priv.to_bytes(32, "big")
        h1 = digest
        v = b"\x01" * 32
        k = b"\x00" * 32
        k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
        k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
        while True:
            v = hmac.new(k, v, hashlib.sha256).digest()
            kcand = int.from_bytes(v, "big")
            if 1 <= kcand < SECP_N:
                r_pt = _ec_mul(kcand, SECP_G)
                r = r_pt[0] % SECP_N
                if r != 0:
                    s = pow(kcand, -1, SECP_N) * (z + r * self.priv) % SECP_N
                    if s != 0:
                        recid = r_pt[1] & 1
                        if s > SECP_N // 2:
                            s = SECP_N - s
                            recid ^= 1
                        return (r.to_bytes(32, "big") + s.to_bytes(32, "big")
                                + bytes([recid]))
            k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
            v = hmac.new(k, v, hashlib.sha256).digest()

    def personal_sign(self, message: bytes) -> bytes:
        prefixed = (b"\x19Ethereum Signed Message:\n"
                    + str(len(message)).encode() + message)
        return self._sign_digest(keccak256(prefixed))

    def sik_signature(self, message: bytes = DEFAULT_SIK_MESSAGE) -> bytes:
        """64-byte signature (recovery byte dropped, mirroring
        upstream ts_inputs/src/inputs.ts:6-13)."""
        return self.personal_sign(message)[:64]
