"""Native R1CS constraint-system builder (replaces the circom toolchain).

The reference compiles circuit/census.circom with the circom compiler into
an .r1cs blob interpreted by snarkjs/rapidsnark
(upstream circuit/circuit-compiler.sh:91).  The circuit family here
is fixed and known, so this framework builds the constraint system natively:
a small symbolic DSL over linear combinations of witness indices, used by
models/census.py to emit the exact statement of
upstream circuit/census.circom:49-115.

Witness layout convention (documented, circom-compatible in spirit):
  index 0            : constant 1
  1 .. n_public      : public inputs, template declaration order
  then private inputs, then internal signals in gadget allocation order.

Coefficients are plain Python ints mod r; export_arrays() converts to the
Montgomery limb arrays the device prover consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import ff, lm

P = ff.P_FR

# A linear combination is a dict {witness_index: coeff mod P}.
LC = dict


def lc(*terms) -> LC:
    """lc((idx, coeff), ...) with merging."""
    out: LC = {}
    for idx, c in terms:
        c %= P
        if c:
            out[idx] = (out.get(idx, 0) + c) % P
            if out[idx] == 0:
                del out[idx]
    return out


def lc_const(c: int) -> LC:
    return lc((0, c))


def lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for idx, c in b.items():
        out[idx] = (out.get(idx, 0) + c) % P
        if out[idx] == 0:
            del out[idx]
    return out


def lc_sub(a: LC, b: LC) -> LC:
    return lc_add(a, lc_scale(b, P - 1))


def lc_scale(a: LC, k: int) -> LC:
    k %= P
    if k == 0:
        return {}
    return {idx: (c * k) % P for idx, c in a.items()}


@dataclass
class ConstraintSystem:
    num_public: int = 0          # count of public inputs (excl. the 1)
    num_vars: int = 1            # index 0 reserved for constant 1
    constraints: list = field(default_factory=list)  # (A, B, C) LC triples

    def alloc(self, n: int = 1) -> int:
        start = self.num_vars
        self.num_vars += n
        return start

    def enforce(self, a: LC, b: LC, c: LC) -> None:
        """<a,w> * <b,w> = <c,w>"""
        self.constraints.append((a, b, c))

    def enforce_linear(self, a: LC, c: LC) -> None:
        """<a,w> = <c,w>  (B row = constant 1)"""
        self.enforce(a, lc_const(1), c)

    def enforce_zero(self, a: LC) -> None:
        self.enforce_linear(a, {})

    def enforce_bit(self, idx: int) -> None:
        self.enforce(lc((idx, 1)), lc((idx, 1), (0, P - 1)), {})

    # -- multiplication helper: allocates the product signal ----------------
    def mul(self, a: LC, b: LC) -> tuple[int, LC]:
        out = self.alloc()
        self.enforce(a, b, lc((out, 1)))
        return out, lc((out, 1))

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    # -- export -------------------------------------------------------------
    def export_arrays(self, extra_rows=()):
        """Returns dict with, for each of a/b/c: (rows, cols, coeffs_mont)
        numpy arrays over the nonzero entries, plus shape metadata.

        Coefficients are exported in Montgomery R-form (c * R mod p): the
        device sparse matvec computes mont_mul(cR, wR) = c*w*R mod p per
        entry — already Montgomery form — then segment-sums limbs (sums
        stay < 2^24 per limb) and weak-normalizes; no extra reduction.

        extra_rows: additional (A, B, C) rows appended after the circuit
        constraints (the prover's public-input binding rows)."""
        out = {}
        r1 = lm.FR.r_mod_p % P
        all_rows = list(self.constraints) + list(extra_rows)
        for name, sel in (("a", 0), ("b", 1), ("c", 2)):
            rows, cols, coeffs = [], [], []
            for r, con in enumerate(all_rows):
                entries = con[sel]
                rows.extend([r] * len(entries))
                cols.extend(entries.keys())
                coeffs.extend(entries.values())
            # few distinct coefficients (the Poseidon constants, +-1):
            # each is put in R-form and cut into limbs once
            distinct: dict = {}
            which = [distinct.setdefault(cf, len(distinct)) for cf in coeffs]
            limbs = lm.ints_to_limb_rows([cf * r1 % P for cf in distinct])
            out[name] = (
                np.asarray(rows, dtype=np.int32),
                np.asarray(cols, dtype=np.int32),
                limbs[np.asarray(which, dtype=np.int64)][:, :, None],
            )                                           # (nnz, 21, 1)
        out["num_constraints"] = len(all_rows)
        out["num_vars"] = self.num_vars
        out["num_public"] = self.num_public
        return out

    # -- host-side satisfaction check (tests) --------------------------------
    def check_satisfied(self, w: list[int]) -> int | None:
        """Returns the index of the first violated constraint, or None."""
        assert len(w) == self.num_vars
        for i, (a, b, c) in enumerate(self.constraints):
            av = sum(cf * w[idx] for idx, cf in a.items()) % P
            bv = sum(cf * w[idx] for idx, cf in b.items()) % P
            cv = sum(cf * w[idx] for idx, cf in c.items()) % P
            if av * bv % P != cv:
                return i
        return None
