"""zkCensus circuit family: native constraint builder + batched witness gen.

The statement of the upstream circuit (circuit/census.circom:49-115) as a
native R1CS (models/r1cs.py) plus a witness generator batched over voters
in PyTorch; the constraint builder is the JAX package's, unchanged.

Statement proven:
  1. voteWeight <= availableWeight
  2. sik = Poseidon(address, password, signature)
  3. (address -> sik) included under sikRoot
  4. (address -> availableWeight) under censusRoot
  5. nullifier == Poseidon(signature, password, electionId[0..1])
  6. voteHash[2] present in the witness, unconstrained

Public-signal order: electionId[0], electionId[1], nullifier, voteHash[0],
voteHash[1], sikRoot, censusRoot, voteWeight.

Every gadget allocates a contiguous block of signals and the witness
generator fills the same blocks in the same order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ff, lm
from ..ops.lm import FR, N_LIMBS
from ..ops.cuda import lm_kernels as K
from ..ops.poseidon_constants import N_ROUNDS_F, N_ROUNDS_P, constants
from . import r1cs
from .r1cs import LC, lc, lc_add, lc_const, lc_scale, lc_sub

P = ff.P_FR


# ---------------------------------------------------------------------------
# build-side gadgets (symbolic)
# ---------------------------------------------------------------------------

def _build_sbox(cs: r1cs.ConstraintSystem, x: LC) -> LC:
    _, y2 = cs.mul(x, x)
    _, y4 = cs.mul(y2, y2)
    _, y5 = cs.mul(y4, x)
    return y5


def build_poseidon(cs: r1cs.ConstraintSystem, inputs: list[LC]) -> LC:
    """Poseidon gadget; allocates 3 signals per sbox in round-major,
    lane-major, (x2,x4,x5)-minor order.  Returns the output LC."""
    t = len(inputs) + 1
    c, m = constants(t)
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    half = r_f // 2
    state = [lc_const(0)] + list(inputs)
    for r in range(r_f + r_p):
        state = [lc_add(state[i], lc_const(c[r * t + i])) for i in range(t)]
        if r < half or r >= half + r_p:
            state = [_build_sbox(cs, x) for x in state]
        else:
            state[0] = _build_sbox(cs, state[0])
        state = [
            functools.reduce(lc_add,
                             (lc_scale(state[j], m[i][j]) for j in range(t)))
            for i in range(t)
        ]
    return state[0]


def build_num2bits(cs: r1cs.ConstraintSystem, x: LC, n: int) -> int:
    """Allocates n bit signals (LSB first), enforces booleanity and the
    recomposition sum.  Returns the start index of the bit block."""
    start = cs.alloc(n)
    acc: LC = {}
    for i in range(n):
        cs.enforce_bit(start + i)
        acc = lc_add(acc, lc((start + i, 1 << i)))
    cs.enforce_linear(acc, x)
    return start


def build_leq_const(cs: r1cs.ConstraintSystem, bit_start: int, n: int,
                    c_val: int) -> int:
    """Enforce that the n-bit value (bits at bit_start, LSB first) is <= c_val.
    Allocates one eq-chain signal per 1-bit of c_val, MSB->LSB order.
    Returns the number of allocated signals."""
    eq: LC = lc_const(1)
    n_alloc = 0
    for i in range(n - 1, -1, -1):
        bi = lc((bit_start + i, 1))
        if (c_val >> i) & 1:
            _, eq = cs.mul(eq, bi)
            n_alloc += 1
        else:
            cs.enforce(eq, bi, {})
    return n_alloc


def build_smt_inclusion(cs: r1cs.ConstraintSystem, key_bit_start: int,
                        key_lc: LC, value_lc: LC, root_lc: LC,
                        sibling_start: int, n_sib: int) -> None:
    """Merkle-inclusion gadget over the arbo/circomlib truncated SMT.
    Allocation order: lev[n_sib+1] | leaf-poseidon block | c_top mult |
    per level i = n_sib-1 .. 0: [switch mult | node-poseidon block |
    m1 | m2]."""
    L = n_sib
    lev_start = cs.alloc(L + 1)
    lev_sum: LC = {}
    for i in range(L + 1):
        cs.enforce_bit(lev_start + i)
        lev_sum = lc_add(lev_sum, lc((lev_start + i, 1)))
    cs.enforce_linear(lev_sum, lc_const(1))
    # after_i = sum_{j<=i} lev_j ; siblings at depth >= d must be zero
    after: list[LC] = []
    acc: LC = {}
    for i in range(L):
        acc = lc_add(acc, lc((lev_start + i, 1)))
        after.append(dict(acc))
        cs.enforce(lc((sibling_start + i, 1)), acc, {})

    leaf = build_poseidon(cs, [key_lc, value_lc, lc_const(1)])

    # c_L = lev_L * leaf
    _, c_next = cs.mul(lc((lev_start + L, 1)), leaf)
    for i in range(L - 1, -1, -1):
        s_i = lc((sibling_start + i, 1))
        b_i = lc((key_bit_start + i, 1))
        _, m_sw = cs.mul(b_i, lc_sub(s_i, c_next))
        left = lc_add(c_next, m_sw)
        right = lc_sub(lc_add(s_i, c_next), left)
        h_i = build_poseidon(cs, [left, right])
        _, m1 = cs.mul(lc((lev_start + i, 1)), leaf)
        _, m2 = cs.mul(lc_sub(lc_const(1), after[i]), h_i)
        c_next = lc_add(m1, m2)
    cs.enforce_linear(c_next, root_lc)


# ---------------------------------------------------------------------------
# circuit assembly
# ---------------------------------------------------------------------------

N_PUBLIC = 8
# public input indices (1-based after the constant):
IDX_EID0, IDX_EID1, IDX_NULLIFIER, IDX_VOTEHASH0, IDX_VOTEHASH1, \
    IDX_SIKROOT, IDX_CENSUSROOT, IDX_VOTEWEIGHT = range(1, 9)
IDX_AVAILWEIGHT, IDX_ADDRESS, IDX_PASSWORD, IDX_SIGNATURE = range(9, 13)
FIRST_SIBLING = 13

KEY_BITS = 254
WEIGHT_BITS = 253  # LessEqThan(252) decomposes a 253-bit value


def build_census_cs(n_levels: int) -> r1cs.ConstraintSystem:
    """Constraint system for ZkFranchiseProofCircuit(n_levels).
    Sibling arrays have length n_levels+1 (census.circom:50,66-67).

    Sets ``cs.gadget_rows``: {gadget name: (first_row, end_row)} — used by
    the adversarial witness-mutation tests to assert that corrupting a
    gadget's witness block violates one of THAT gadget's constraints."""
    L = n_levels + 1
    cs = r1cs.ConstraintSystem(num_public=N_PUBLIC)
    cs.alloc(12 + 2 * L)  # publics + scalar privates + sibling arrays
    cens_sib = FIRST_SIBLING
    sik_sib = FIRST_SIBLING + L

    marks = {}

    def mark(name, fn, *args, **kw):
        r0, v0 = cs.num_constraints, cs.num_vars
        out = fn(*args, **kw)
        marks[name] = {"rows": (r0, cs.num_constraints),
                       "vars": (v0, cs.num_vars)}
        return out

    one = lc_const(1)
    vw = lc((IDX_VOTEWEIGHT, 1))
    aw = lc((IDX_AVAILWEIGHT, 1))
    addr = lc((IDX_ADDRESS, 1))
    pwd = lc((IDX_PASSWORD, 1))
    sig = lc((IDX_SIGNATURE, 1))

    # 1. weight check: bits of E = vw + 2^252 - 1 - aw, top bit must be 0
    def weight_gadget():
        e_lc = lc_add(lc_sub(vw, aw), lc_const((1 << 252) - 1))
        wstart = build_num2bits(cs, e_lc, WEIGHT_BITS)
        cs.enforce_zero(lc((wstart + WEIGHT_BITS - 1, 1)))
        return wstart

    mark("weight", weight_gadget)

    # 2. address bit decomposition, strict (value < r)
    abits = mark("addr_bits", build_num2bits, cs, addr, KEY_BITS)
    mark("addr_strict", build_leq_const, cs, abits, KEY_BITS, P - 1)

    # 3. SIK = Poseidon(address, password, signature)
    sik_out = mark("sik_poseidon", build_poseidon, cs, [addr, pwd, sig])

    # 4. SIK tree inclusion
    mark("sik_tree", build_smt_inclusion, cs, abits, addr, sik_out,
         lc((IDX_SIKROOT, 1)), sik_sib, L)

    # 5. census tree inclusion
    mark("census_tree", build_smt_inclusion, cs, abits, addr, aw,
         lc((IDX_CENSUSROOT, 1)), cens_sib, L)

    # 6. nullifier
    def nullifier_gadget():
        null_out = build_poseidon(cs, [sig, pwd,
                                       lc((IDX_EID0, 1)), lc((IDX_EID1, 1))])
        cs.enforce_linear(null_out, lc((IDX_NULLIFIER, 1)))

    mark("nullifier", nullifier_gadget)
    _ = one
    cs.gadget_rows = marks
    return cs


# ---------------------------------------------------------------------------
# eval-side gadgets (limb-major Montgomery planes, voters on the last axis)
# ---------------------------------------------------------------------------
# A field element is (21, T); signal blocks stack elements on the LEADING
# axis, matching the witness layout (num_vars, 21, T).

def _bits_to_mont(bits: torch.Tensor) -> torch.Tensor:
    """(n, ..., T) 0/1 -> (n, ..., 21, T) Montgomery field elements."""
    one = lm.const(FR.one_mont, bits.device)          # (21, 1)
    zero = torch.zeros((), dtype=lm.DTYPE, device=bits.device)
    return torch.where((bits == 1)[..., None, :], one, zero)


def eval_poseidon_trace(inputs_mont: torch.Tensor):
    """Poseidon with sbox-intermediate capture.
    inputs_mont: (k, 21, T) -> (out (21, T), trace (n_sbox*3, 21, T));
    trace order matches build_poseidon allocation order.  On the card one
    launch of the permutation kernel; on the CPU its plain version."""
    return K.poseidon_trace(inputs_mont)


def eval_leq_const_trace(bits: torch.Tensor, c_val: int,
                         n: int) -> torch.Tensor:
    """(n, T) 0/1 bits -> (n_ones, 21, T) eq-chain signals in MSB->LSB
    order over positions where c_val has a 1-bit."""
    sel = bits[lm.const(_ones_pos(c_val, n), bits.device)]
    return _bits_to_mont(torch.cumprod(sel, 0, dtype=lm.DTYPE))


@functools.lru_cache(maxsize=None)
def _ones_pos(c_val: int, n: int) -> np.ndarray:
    """Positions of c_val's 1-bits below n, most significant first (held
    for the life of the process, so lm.const copies them to a device
    once)."""
    return np.asarray([i for i in range(n - 1, -1, -1) if (c_val >> i) & 1],
                      dtype=np.int64)


def eval_smt_trace(key_bits: torch.Tensor, key_mont: torch.Tensor,
                   value_mont: torch.Tensor, siblings_plain: torch.Tensor,
                   siblings_mont: torch.Tensor):
    """Witness block for build_smt_inclusion.
    key_bits: (>=L, T) 0/1; key/value mont (21, T);
    siblings (L, 21, T).  Returns (root (21, T), block (block_len, 21, T))."""
    L = siblings_plain.shape[0]
    T = key_mont.shape[-1]
    dev = key_mont.device
    one = lm.const(FR.one_mont, dev).expand(N_LIMBS, T)

    nz = (siblings_plain != 0).any(dim=-2)                  # (L, T)
    # depth d = last nonzero index + 1  (0 if none)
    idx = torch.arange(1, L + 1, dtype=lm.DTYPE, device=dev)[:, None]
    d = torch.where(nz, idx, torch.zeros_like(idx)).max(dim=0).values
    lev = (torch.arange(L + 1, dtype=lm.DTYPE, device=dev)[:, None]
           == d[None, :]).to(lm.DTYPE)                      # (L+1, T)
    after = torch.cumsum(lev[:L], 0, dtype=lm.DTYPE)        # (L, T) 0/1
    lev_mont = _bits_to_mont(lev)
    after_mont = _bits_to_mont(after)
    bit_mont = _bits_to_mont(key_bits[:L])

    leaf, leaf_tr = eval_poseidon_trace(
        torch.stack([key_mont, value_mont, one], 0))
    c_top = lm.mont_mul(lev_mont[L], leaf, FR)

    # levels i = L-1 .. 0; c_next stays weak-normalized (value < 2p)
    c_next = c_top
    blocks = []
    for i in range(L - 1, -1, -1):
        s_m = siblings_mont[i]
        m_sw = lm.mont_mul(bit_mont[i], lm.sub_n(s_m, c_next, FR), FR)
        left = lm.weak_norm(c_next + m_sw)
        right = lm.sub_n(s_m + c_next, left, FR)
        h, h_tr = eval_poseidon_trace(torch.stack([left, right], 0))
        m1 = lm.mont_mul(lev_mont[i], leaf, FR)
        m2 = lm.mont_mul(lm.sub_n(one, after_mont[i], FR), h, FR)
        c_next = lm.weak_norm(m1 + m2)
        blocks += [m_sw[None], h_tr, m1[None], m2[None]]
    full = torch.cat([lev_mont, leaf_tr, c_top[None], *blocks], 0)
    return c_next, full


# ---------------------------------------------------------------------------
# full witness generator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CensusCircuit:
    n_levels: int

    @functools.cached_property
    def cs(self) -> r1cs.ConstraintSystem:
        return build_census_cs(self.n_levels)

    @property
    def sibling_len(self) -> int:
        return self.n_levels + 1

    def witness(self, inputs: dict) -> torch.Tensor:
        """Batched witness generation.

        inputs: dict of plain-form limb-major int32 tensors (T voters on
          the last axis, all on one device) — 'electionId' (2, 21, T),
          'nullifier' (21, T), 'availableWeight', 'voteHash' (2, 21, T),
          'sikRoot', 'censusRoot', 'address', 'password', 'signature',
          'voteWeight' (21, T), 'censusSiblings' (L, 21, T),
          'sikSiblings' (L, 21, T).
        Returns the witness (num_vars, 21, T) in Montgomery form.
        """
        m = lm.to_mont
        eid = m(inputs["electionId"])
        nullifier = m(inputs["nullifier"])
        aw_plain = inputs["availableWeight"]
        aw = m(aw_plain)
        votehash = m(inputs["voteHash"])
        sik_root = m(inputs["sikRoot"])
        census_root = m(inputs["censusRoot"])
        addr_plain = inputs["address"]
        addr = m(addr_plain)
        pwd = m(inputs["password"])
        sig = m(inputs["signature"])
        vw_plain = inputs["voteWeight"]
        vw = m(vw_plain)
        cens_sib_plain = inputs["censusSiblings"]
        sik_sib_plain = inputs["sikSiblings"]
        cens_sib = m(cens_sib_plain)
        sik_sib = m(sik_sib_plain)

        T = addr.shape[-1]
        dev = addr.device
        one_mont = lm.const(FR.one_mont, dev).expand(N_LIMBS, T)

        parts = [
            one_mont[None],
            eid[0:1], eid[1:2],
            nullifier[None],
            votehash[0:1], votehash[1:2],
            sik_root[None], census_root[None],
            vw[None], aw[None], addr[None],
            pwd[None], sig[None],
            cens_sib, sik_sib,
        ]

        # 1. weight bits: E = vw + 2^252 - 1 - aw (canonical plain form —
        # the bit decomposition needs the EXACT [0, p) representative)
        e_const = lm.const(_E_CONST, dev)
        e_val = lm.canon(lm.sub_n(vw_plain + e_const, aw_plain, FR), FR)
        parts.append(_bits_to_mont(lm.bits_from_plain(e_val, WEIGHT_BITS)))

        # 2. address bits + strict eq chain
        abits = lm.bits_from_plain(addr_plain, KEY_BITS)     # (254, T)
        parts.append(_bits_to_mont(abits))
        parts.append(eval_leq_const_trace(abits, P - 1, KEY_BITS))

        # 3. SIK poseidon
        sik_out, sik_tr = eval_poseidon_trace(
            torch.stack([addr, pwd, sig], 0))
        parts.append(sik_tr)

        # 4. SIK tree
        _, sik_block = eval_smt_trace(abits, addr, sik_out,
                                      sik_sib_plain, sik_sib)
        parts.append(sik_block)

        # 5. census tree
        _, cens_block = eval_smt_trace(abits, addr, aw,
                                       cens_sib_plain, cens_sib)
        parts.append(cens_block)

        # 6. nullifier poseidon
        _, null_tr = eval_poseidon_trace(
            torch.stack([sig, pwd, eid[0], eid[1]], 0))
        parts.append(null_tr)

        w = torch.cat(parts, 0)
        assert w.shape[0] == self.cs.num_vars, (w.shape, self.cs.num_vars)
        return w

    def public_signals(self, w: torch.Tensor) -> torch.Tensor:
        """(8, 21, T) plain form, reference signal order."""
        return lm.from_mont(w[1:1 + N_PUBLIC], FR)


_E_CONST = lm.int_to_limbs((1 << 252) - 1)[:, None].astype(np.int32)


def inputs_to_limbs(inp: dict, n_levels: int) -> dict:
    """Decimal-string/int input dict (the upstream inputs_example.json
    schema) -> plain limb-major numpy arrays for a single voter (T = 1):
    scalars (21, 1), vectors (k, 21, 1)."""
    L = n_levels + 1

    def one(x):
        return lm.int_to_limbs(int(x))[:, None].astype(np.int32)

    def many(xs):
        return np.stack([one(x) for x in xs], axis=0)

    cs_ = [int(x) for x in inp["censusSiblings"]][:L]
    ss = [int(x) for x in inp["sikSiblings"]][:L]
    assert len(cs_) == L and len(ss) == L
    return {
        "electionId": many(inp["electionId"]),
        "nullifier": one(inp["nullifier"]),
        "availableWeight": one(inp["availableWeight"]),
        "voteHash": many(inp["voteHash"]),
        "sikRoot": one(inp["sikRoot"]),
        "censusRoot": one(inp["censusRoot"]),
        "address": one(inp["address"]),
        "password": one(inp["password"]),
        "signature": one(inp["signature"]),
        "voteWeight": one(inp["voteWeight"]),
        "censusSiblings": many(cs_),
        "sikSiblings": many(ss),
    }
