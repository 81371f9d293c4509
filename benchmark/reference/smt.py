"""vocdoni arbo's sparse Merkle tree, as the census circuit checks it.

A leaf hashes as Poseidon(key, value, 1), an inner node as
Poseidon(left, right), an empty subtree is 0.  A key's path is the bits of
its little-endian integer, least significant first, and its leaf sits at
the first level where that path parts from every other key's (upstream
internal/helpers.go:36-85).  Siblings run from the root down, zero-padded
to the circuit's nlevels + 1.
"""
from __future__ import annotations

import hashlib

from . import poseidon


def le_int(data: bytes) -> int:
    """arbo.BytesToBigInt: little-endian bytes -> integer."""
    return int.from_bytes(data, "little")


def bytes_to_arbo(data: bytes) -> tuple:
    """BytesToArbo: sha256(data) as two little-endian 128-bit halves."""
    h = hashlib.sha256(data).digest()
    return le_int(h[:16]), le_int(h[16:])


def leaf_hash(key: int, value: int) -> int:
    return poseidon.hash_([key, value, 1])


def build(leaves: dict, max_levels: int) -> tuple:
    """leaves {key: value} -> (root, {key: siblings from the root down,
    up to the leaf}).  Raises ValueError when two keys share their first
    max_levels path bits (arbo's "max level reached")."""
    siblings = {key: [] for key in leaves}

    def node(keys: list, level: int) -> int:
        if not keys:
            return 0
        if len(keys) == 1:
            return leaf_hash(keys[0], leaves[keys[0]])
        if level >= max_levels:
            raise ValueError("max level reached")
        left = [k for k in keys if not (k >> level) & 1]
        right = [k for k in keys if (k >> level) & 1]
        hl, hr = node(left, level + 1), node(right, level + 1)
        for k in left:
            siblings[k].append(hr)
        for k in right:
            siblings[k].append(hl)
        return poseidon.hash_([hl, hr])

    root = node(sorted(leaves), 0)
    # node() appends on the way back up: leaf level first
    return root, {k: s[::-1] for k, s in siblings.items()}


def root_from_path(key: int, value: int, siblings: list) -> int:
    """The root that a leaf and its padded siblings give: the leaf's depth
    is one past the last non-zero sibling, as the circuit takes it."""
    depth = max((i + 1 for i, s in enumerate(siblings) if s), default=0)
    h = leaf_hash(key, value)
    for i in range(depth - 1, -1, -1):
        sib = siblings[i]
        h = poseidon.hash_([sib, h] if (key >> i) & 1 else [h, sib])
    return h
