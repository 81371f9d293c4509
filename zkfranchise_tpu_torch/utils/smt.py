"""Arbo-compatible sparse Merkle tree (host build + proof extraction).

Replicates the observable behavior of vocdoni's arbo tree as used at
upstream internal/helpers.go:36-85:
  * leaf node hash  = Poseidon(key, value, 1)
  * intermediate    = Poseidon(left, right)
  * empty subtree   = 0
  * a leaf sits at the first level where its path (LSB-first key bits)
    diverges from every other key (truncated/compressed SMT), so sibling
    arrays may contain zeros mid-path and the deepest used sibling is
    always nonzero.

The tree is insertion-order independent (canonical per key set).  This host
implementation is the input-pipeline / fixture side of the framework (the
reference's pebbledb+arbo stack, SURVEY.md §2b); the in-circuit verification
and batched root recomputation live in models/census.py and ops/.

Golden-tested against censusRoot/sikRoot + sibling vectors in
upstream artifacts/zkCensus/dev/160/inputs_example.json.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ops import ff
from ..ops.poseidon_constants import poseidon_host
from . import arbo


@dataclass
class _Leaf:
    key_int: int   # little-endian integer of the key bytes (path source)
    value_int: int
    hash: int


class _Mid:
    __slots__ = ("left", "right", "hash")

    def __init__(self, left, right):
        self.left = left
        self.right = right
        self.hash = poseidon_host([_h(left), _h(right)])


def _h(node) -> int:
    return 0 if node is None else node.hash


def leaf_hash(key_int: int, value_int: int) -> int:
    return poseidon_host([key_int, value_int, 1])


class SMT:
    """Arbo-semantics sparse Merkle tree over BN254 Fr."""

    def __init__(self, max_levels: int = 160):
        self.max_levels = max_levels
        self.root_node = None
        self._keys: set[int] = set()

    @property
    def root(self) -> int:
        return _h(self.root_node)

    def add(self, key_bytes: bytes, value_int: int) -> None:
        key_int = arbo.bytes_to_bigint(key_bytes)
        if key_int in self._keys:
            raise ValueError("key already exists")
        if value_int >= ff.P_FR or key_int >= ff.P_FR:
            raise ValueError("key/value exceeds field modulus")
        leaf = _Leaf(key_int, value_int, leaf_hash(key_int, value_int))
        self.root_node = self._insert(self.root_node, leaf, 0)
        self._keys.add(key_int)

    def _insert(self, node, leaf: _Leaf, level: int):
        if level >= self.max_levels:
            raise ValueError("max level reached")
        if node is None:
            return leaf
        if isinstance(node, _Leaf):
            # push both leaves down until their paths diverge
            return self._split(node, leaf, level)
        bit = (leaf.key_int >> level) & 1
        if bit:
            return _Mid(node.left, self._insert(node.right, leaf, level + 1))
        return _Mid(self._insert(node.left, leaf, level + 1), node.right)

    def _split(self, a: _Leaf, b: _Leaf, level: int):
        if level >= self.max_levels:
            raise ValueError("max level reached")
        abit = (a.key_int >> level) & 1
        bbit = (b.key_int >> level) & 1
        if abit == bbit:
            child = self._split(a, b, level + 1)
            return _Mid(None, child) if abit else _Mid(child, None)
        return _Mid(a, b) if bbit else _Mid(b, a)

    def gen_proof(self, key_bytes: bytes) -> tuple[int, list[int]]:
        """Returns (value, siblings) for an existing key; siblings ordered
        root-level first, truncated at the leaf depth (arbo UnpackSiblings
        semantics before zero-padding)."""
        key_int = arbo.bytes_to_bigint(key_bytes)
        node = self.root_node
        siblings: list[int] = []
        level = 0
        while True:
            if node is None:
                raise KeyError("key does not exist")
            if isinstance(node, _Leaf):
                if node.key_int != key_int:
                    raise KeyError("key does not exist")
                return node.value_int, siblings
            bit = (key_int >> level) & 1
            if bit:
                siblings.append(_h(node.left))
                node = node.right
            else:
                siblings.append(_h(node.right))
                node = node.left
            level += 1

    def padded_siblings(self, key_bytes: bytes, n: int) -> list[int]:
        """Siblings zero-padded to length n (reference pads to 160 then
        appends one more 0 for the circuit's nLevels+1 arrays —
        upstream internal/helpers.go:72-79, inputs.go:52,72)."""
        _, sibs = self.gen_proof(key_bytes)
        if len(sibs) > n:
            raise ValueError("proof deeper than padding length")
        return sibs + [0] * (n - len(sibs))


def verify_proof(root: int, key_int: int, value_int: int,
                 siblings: list[int]) -> bool:
    """Host-side inclusion check (same rule the circuit enforces): leaf depth
    is (last nonzero sibling index)+1; all deeper siblings must be zero."""
    last = -1
    for i, s in enumerate(siblings):
        if s != 0:
            last = i
    depth = last + 1
    h = leaf_hash(key_int, value_int)
    for i in range(depth - 1, -1, -1):
        bit = (key_int >> i) & 1
        h = poseidon_host([siblings[i], h] if bit else [h, siblings[i]])
    return h == root
