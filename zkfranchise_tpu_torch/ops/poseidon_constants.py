"""Poseidon round constants + MDS matrices for the circomlib BN254 variant.

The reference circuit hashes with circomlib Poseidon
(upstream circuit/census.circom:3,74,105; circomlibjs at
upstream ts_inputs/src/inputs.ts:16-36).  Those constants were
generated with the Grain-LFSR procedure from the original Poseidon paper
(generate_parameters_grain.sage) over the BN254 scalar field with
R_F = 8 full rounds and a per-width partial-round count.  We regenerate them
here from the same procedure rather than shipping a constants blob; the
results are locked down bit-exactly by golden-vector tests against
upstream artifacts/zkCensus/dev/160/inputs_example.json (nullifier,
sikRoot, censusRoot are all Poseidon images of known preimages).
"""
from __future__ import annotations

import functools

from . import ff

P = ff.P_FR
N_ROUNDS_F = 8
# partial rounds for t = 2..17 (circomlib table)
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
FIELD_BITS = 254


class _Grain:
    """Grain LFSR stream per generate_parameters_grain.sage."""

    def __init__(self, t: int, r_f: int, r_p: int):
        bits = []
        bits += self._int_bits(1, 2)           # field tag: GF(p)
        bits += self._int_bits(0, 4)           # sbox: x^alpha
        bits += self._int_bits(FIELD_BITS, 12)  # field size n
        bits += self._int_bits(t, 12)
        bits += self._int_bits(r_f, 10)
        bits += self._int_bits(r_p, 10)
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_bit()

    @staticmethod
    def _int_bits(x: int, width: int) -> list[int]:
        return [(x >> (width - 1 - i)) & 1 for i in range(width)]

    def _next_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def next_filtered_bit(self) -> int:
        # emit bit2 of the first pair whose bit1 == 1
        while True:
            b1 = self._next_bit()
            b2 = self._next_bit()
            if b1 == 1:
                return b2

    def next_bits_int(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.next_filtered_bit()
        return v

    def next_field_element_rejection(self) -> int:
        while True:
            v = self.next_bits_int(FIELD_BITS)
            if v < P:
                return v

    def next_field_element_mod(self) -> int:
        return self.next_bits_int(FIELD_BITS) % P


@functools.lru_cache(maxsize=None)
def constants(t: int) -> tuple[tuple[int, ...], tuple[tuple[int, ...], ...]]:
    """Round constants C (length t*(R_F+R_P)) and MDS matrix M (t x t) for
    state width t (i.e. Poseidon with t-1 inputs)."""
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(t, N_ROUNDS_F, r_p)
    n_const = t * (N_ROUNDS_F + r_p)
    c = tuple(g.next_field_element_rejection() for _ in range(n_const))
    xs = [g.next_field_element_mod() for _ in range(t)]
    ys = [g.next_field_element_mod() for _ in range(t)]
    m = tuple(
        tuple(ff.inv_mod((xs[i] + ys[j]) % P, P) for j in range(t))
        for i in range(t)
    )
    return c, m


def poseidon_host(inputs: list[int]) -> int:
    """Reference (host bigint) Poseidon matching circomlibjs poseidon().

    State width t = len(inputs)+1, initial state [0, *inputs]; every round is
    ark -> sbox(x^5, full or state[0] only) -> MDS mix with
    new_state[i] = sum_j M[i][j] * state[j]; output is state[0]."""
    t = len(inputs) + 1
    assert 2 <= t <= 17
    c, m = constants(t)
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    state = [0] + [x % P for x in inputs]
    for r in range(r_f + r_p):
        state = [(state[i] + c[r * t + i]) % P for i in range(t)]
        if r < r_f // 2 or r >= r_f // 2 + r_p:
            state = [pow(x, 5, P) for x in state]
        else:
            state[0] = pow(state[0], 5, P)
        state = [
            sum(m[i][j] * state[j] for j in range(t)) % P
            for i in range(t)
        ]
    return state[0]
