"""Batched (device-hashed) arbo SMT builder for census construction.

utils/smt.py hashes one node per Python call — fine for fixtures, but at
census scale (2^16 voters) input generation would dominate the proof
stream (SURVEY.md §2b: "batched SMT in JAX: build census trees of 2^k
leaves, vectorized proof extraction for thousands of voters";
upstream internal/helpers.go:36-85).

Split of labor here:
  * host: TOPOLOGY only — insertion/divergence layout of the compressed
    arbo tree (cheap integer ops, no hashing);
  * device: ALL hashes — one vectorized Poseidon call per tree tier
    (leaves: arity 3 in one call; then one arity-2 call per depth,
    bottom-up), nodes riding the 128-wide lane axis (ops/poseidon.py).

Roots and sibling vectors are bit-equal to utils/smt.SMT (parity-tested);
proof extraction is a host walk reading device-computed hashes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import ff, lm
from ..ops.lm import FR
from ..ops.poseidon import poseidon_mont
from . import arbo

_PAD = 128


class _N:
    """Structural node: leaf iff key is not None."""
    __slots__ = ("left", "right", "key", "value", "hash", "depth")

    def __init__(self, key=None, value=None, left=None, right=None):
        self.key = key
        self.value = value
        self.left = left
        self.right = right
        self.hash = None
        self.depth = 0


def hash_batch(rows: list[list[int]], device) -> list[int]:
    """One vectorized Poseidon call on `device`: rows of k plain ints ->
    digests."""
    k = len(rows[0])
    n = len(rows)
    n_pad = max(_PAD, 1 << (n - 1).bit_length())
    cols = [[r[i] for r in rows] + [0] * (n_pad - n) for i in range(k)]
    x = torch.as_tensor(np.stack([lm.ints_to_lm(c) for c in cols]),
                        device=device)                  # (k, 21, n_pad)
    out = lm.from_mont(poseidon_mont(lm.to_mont(x, FR)), FR)
    return lm.lm_to_ints(out)[:n]


class BatchSMT:
    """Arbo-semantics tree built from a full key/value batch at once."""

    def __init__(self, entries: list[tuple[int, int]], max_levels: int = 160,
                 *, device):
        """entries: [(key_int, value_int)] — key_int is the little-endian
        arbo integer of the key bytes (arbo.bytes_to_bigint); the hashes
        run on `device`."""
        self.max_levels = max_levels
        self.device = device
        seen = set()
        for k, v in entries:
            if k in seen:
                raise ValueError("duplicate key")
            if k >= ff.P_FR or v >= ff.P_FR:
                raise ValueError("key/value exceeds field modulus")
            seen.add(k)
        self.root_node = None
        for k, v in entries:
            self.root_node = self._insert(self.root_node, _N(k, v), 0)
        self._hash_all()

    # -- topology (mirrors utils/smt.py insertion semantics) ---------------
    def _insert(self, node, leaf: _N, level: int):
        if level >= self.max_levels:
            raise ValueError("max level reached")
        if node is None:
            return leaf
        if node.key is not None:
            return self._split(node, leaf, level)
        bit = (leaf.key >> level) & 1
        if bit:
            return _N(left=node.left,
                      right=self._insert(node.right, leaf, level + 1))
        return _N(left=self._insert(node.left, leaf, level + 1),
                  right=node.right)

    def _split(self, a: _N, b: _N, level: int):
        if level >= self.max_levels:
            raise ValueError("max level reached")
        abit = (a.key >> level) & 1
        bbit = (b.key >> level) & 1
        if abit == bbit:
            child = self._split(a, b, level + 1)
            return _N(left=None, right=child) if abit \
                else _N(left=child, right=None)
        return _N(left=a, right=b) if bbit else _N(left=b, right=a)

    # -- device hashing, one call per tier ----------------------------------
    def _hash_all(self) -> None:
        if self.root_node is None:
            return
        tiers: dict[int, list[_N]] = {}

        def walk(node, d):
            node.depth = d
            tiers.setdefault(d, []).append(node)
            if node.key is None:
                if node.left is not None:
                    walk(node.left, d + 1)
                if node.right is not None:
                    walk(node.right, d + 1)

        walk(self.root_node, 0)
        leaves = [n for ns in tiers.values() for n in ns if n.key is not None]
        if leaves:
            digests = hash_batch([[n.key, n.value, 1] for n in leaves],
                                 self.device)
            for n, h in zip(leaves, digests):
                n.hash = h
        for d in sorted(tiers, reverse=True):
            mids = [n for n in tiers[d] if n.key is None]
            if not mids:
                continue
            rows = [[n.left.hash if n.left else 0,
                     n.right.hash if n.right else 0] for n in mids]
            digests = hash_batch(rows, self.device)
            for n, h in zip(mids, digests):
                n.hash = h

    # -- queries (same API shape as utils/smt.SMT) ---------------------------
    @property
    def root(self) -> int:
        return 0 if self.root_node is None else self.root_node.hash

    def gen_proof(self, key_int: int) -> tuple[int, list[int]]:
        node = self.root_node
        siblings: list[int] = []
        level = 0
        while True:
            if node is None:
                raise KeyError("key does not exist")
            if node.key is not None:
                if node.key != key_int:
                    raise KeyError("key does not exist")
                return node.value, siblings
            bit = (key_int >> level) & 1
            if bit:
                siblings.append(node.left.hash if node.left else 0)
                node = node.right
            else:
                siblings.append(node.right.hash if node.right else 0)
                node = node.left
            level += 1

    def padded_siblings(self, key_int: int, n: int) -> list[int]:
        _, sibs = self.gen_proof(key_int)
        if len(sibs) > n:
            raise ValueError("proof deeper than padding length")
        return sibs + [0] * (n - len(sibs))


def build_from_bytes(entries: list[tuple[bytes, int]],
                     max_levels: int = 160, *, device) -> BatchSMT:
    return BatchSMT([(arbo.bytes_to_bigint(k), v) for k, v in entries],
                    max_levels=max_levels, device=device)
