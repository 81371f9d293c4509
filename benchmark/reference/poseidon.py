"""circomlib's Poseidon over BN254 Fr, for 2 to 4 inputs (t = 3..5).

The round constants and MDS matrices come from the Grain LFSR of the
Poseidon paper's generate_parameters_grain.sage with R_F = 8 full rounds
and circomlib's partial-round counts, regenerated here and not shipped.
A round is: add the round constants, the S-box x^5 (every element in a
full round, element 0 in a partial one), then the MDS mix; the hash is
element 0 of the state [0, *inputs] after all rounds.
"""
from __future__ import annotations

import functools

from .field import P_FR as P

N_ROUNDS_F = 8
# partial rounds for t = 2..17 (circomlib's table)
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
FIELD_BITS = 254


class _Grain:
    """The Grain LFSR bit stream of generate_parameters_grain.sage."""

    def __init__(self, t: int, r_f: int, r_p: int):
        bits = []
        for value, width in ((1, 2), (0, 4), (FIELD_BITS, 12), (t, 12),
                             (r_f, 10), (r_p, 10)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        self.state = bits
        for _ in range(160):
            self._bit()

    def _bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def _filtered(self) -> int:
        while True:
            b1, b2 = self._bit(), self._bit()
            if b1:
                return b2

    def _int(self) -> int:
        v = 0
        for _ in range(FIELD_BITS):
            v = (v << 1) | self._filtered()
        return v

    def element_rejection(self) -> int:
        while True:
            v = self._int()
            if v < P:
                return v

    def element_mod(self) -> int:
        return self._int() % P


@functools.lru_cache(maxsize=None)
def constants(t: int) -> tuple:
    """(round constants, length t * (R_F + R_P); MDS matrix, t x t)."""
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(t, N_ROUNDS_F, r_p)
    c = tuple(g.element_rejection() for _ in range(t * (N_ROUNDS_F + r_p)))
    xs = [g.element_mod() for _ in range(t)]
    ys = [g.element_mod() for _ in range(t)]
    m = tuple(tuple(pow((xs[i] + ys[j]) % P, -1, P) for j in range(t))
              for i in range(t))
    return c, m


def hash_(inputs: list) -> int:
    """Poseidon(inputs) with t = len(inputs) + 1, as circomlibjs computes
    it."""
    t = len(inputs) + 1
    if not 3 <= t <= 5:
        raise ValueError(f"poseidon: 2 to 4 inputs, got {len(inputs)}")
    c, m = constants(t)
    r_p = N_ROUNDS_P[t - 2]
    half = N_ROUNDS_F // 2
    rows = range(t)
    state = [0] + [x % P for x in inputs]
    for r in range(N_ROUNDS_F + r_p):
        base = r * t
        if r < half or r >= half + r_p:
            state = [pow(state[i] + c[base + i], 5, P) for i in rows]
        else:
            state = [state[i] + c[base + i] for i in rows]
            state[0] = pow(state[0], 5, P)
        state = [sum(mi[j] * state[j] for j in rows) % P for mi in m]
    return state[0]
