"""Arbo byte/field encoding conventions.

Arbo (vocdoni's SMT) stores keys and values as little-endian byte strings;
field elements are parsed little-endian.  These helpers replicate the exact
semantics of:
  * arbo.BytesToBigInt / arbo.SwapEndianness used at
    upstream internal/helpers.go:31,75 and
    upstream ts_inputs/src/arbo_utils.ts:10-20,
  * BytesToArbo (sha256 split into two endian-swapped 128-bit halves) at
    upstream internal/helpers.go:28-34 and
    upstream ts_inputs/src/arbo_utils.ts:22-33,
  * BigToFF reduction at upstream internal/helpers.go:17-26 /
    upstream ts_inputs/src/ff.ts:1-18.
"""
from __future__ import annotations

import hashlib

from ..ops import ff


def swap_endianness(b: bytes) -> bytes:
    return bytes(reversed(b))


def bytes_to_bigint(b: bytes) -> int:
    """Little-endian bytes -> int (arbo.BytesToBigInt)."""
    return int.from_bytes(b, "little")


def bigint_to_bytes(x: int, length: int) -> bytes:
    """int -> little-endian bytes of fixed length (arbo.BigIntToBytes)."""
    return x.to_bytes(length, "little")


def bytes_to_arbo(data: bytes) -> tuple[int, int]:
    """sha256(data) split into two 16-byte halves, each parsed little-endian,
    producing two <=128-bit field elements (electionId / voteHash encoding)."""
    h = hashlib.sha256(data).digest()
    return (int.from_bytes(h[:16], "little"), int.from_bytes(h[16:], "little"))


def big_to_ff(x: int) -> int:
    return ff.big_to_ff(x, ff.P_FR)


def key_path_bits(key_bytes: bytes, n_levels: int) -> list[int]:
    """Path bit for each level: bit n = (key[n//8] >> (n%8)) & 1 — i.e. bit n
    of the little-endian integer.  Level 0 chooses the child of the root."""
    k = bytes_to_bigint(key_bytes)
    return [(k >> i) & 1 for i in range(n_levels)]
