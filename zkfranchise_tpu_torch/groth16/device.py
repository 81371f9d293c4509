"""Batched Groth16 prover on the card: the port's main path.

A batch of voters' circuit inputs goes through four stages:
  1. witness generation (models/census.py),
  2. R1CS row evaluation + coset-NTT quotient (ops/sparse.py, ops/ntt.py),
  3. four MSMs (ops/msm_lm.py) with the r/s blinding folded into extended
     scalar/point tables,
  4. proof assembly (two batched scalar-muls, one kernel launch each, +
     point adds).

Every stage shares one data layout (ops/lm.py): field-element vectors are
``(N, 21, B)`` int32 planes, elements on the leading axis, limbs next, the
voter batch B last.  Products go through the CUDA kernels on the card:
poseidon (witness), mont_mul (witness, quotient), fold_padd_aa /
fold_padd / padd (MSMs, assembly), scalar_mul (assembly).  Only the
final projective->affine conversion runs on the host.

``DeviceProver.fused_step`` runs the four stages as one function with no
host copy or synchronisation inside; ``FusedStep`` (``prover.capture(B)``)
replays it as one CUDA graph at a fixed batch.  ``ReplayProver`` keeps one
such graph per batch size, captured at first use into one shared memory
pool, behind ``prove_batch``: the stream's prover on captured steps.

The B1/B2 tables are compacted: wires whose B polynomial is zero carry
identity points (None in the key), and dropping them roughly halves the
padded MSM size.

Past nlevels = SMT_CUT_DEPTH the step has a second set of tables (SmtCut):
the four without the SMT levels below that depth, whose witness is one
constant for every voter above it, and the sum of those rows as one point
a table.  A slice takes them when every lane's leaf lies at or above the
cut depth (models/census.py leaves_within, read on the host), and the full
tables otherwise.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models import census
from ..models.census import CensusCircuit
from ..ops import ec_affine, ec_lm, ff, lm, msm_lm, ntt, sparse
from ..ops.cuda import lm_kernels as K
from ..ops.lm import FR
from ..utils import devices, metrics
from . import qap
from .setup import ProvingKey
from .verify import Proof

P = ff.P_FR


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def witness_stage(circuit: CensusCircuit, inputs: dict):
    """-> (w Montgomery (num_vars, 21, B), w plain canonical, the SMT
    levels each lane of the two trees hashed (2 B,))."""
    w, hashed = circuit.witness_counted(inputs)
    return w, lm.from_mont(w, FR), hashed


def smt_counts(hashed: torch.Tensor, n_levels: int) -> dict:
    """The step's record of the witness's SMT chains: the levels hashed
    over every lane of both trees (one read-back of 2 B integers) and the
    levels there are (2 (n_levels + 1) B)."""
    return {"smt_hashed": sum(hashed.tolist()),
            "smt_levels": hashed.numel() * (n_levels + 1)}


def quotient_stage(arrays: dict, n: int, w: torch.Tensor) -> torch.Tensor:
    """R1CS rows -> coset quotient evals, plain canonical (n, 21, B).

    `arrays` holds device tensors (rows, cols, coeffs) per matrix.  With
    no C matrix (an A/B-only key), the C-row evaluations come from the
    on-domain identity (A.w)*(B.w) = C.w, which holds row by row for a
    satisfying witness."""
    az = sparse.spmv(*arrays["a"], n, w)
    bz = sparse.spmv(*arrays["b"], n, w)
    if "c" in arrays:
        cz = sparse.spmv(*arrays["c"], n, w)
    else:
        cz = lm.mont_mul(az, bz, FR)
    a_cos = ntt.coset_evals_from_domain_evals(az)
    b_cos = ntt.coset_evals_from_domain_evals(bz)
    c_cos = ntt.coset_evals_from_domain_evals(cz)
    # forward-NTT outputs carry value ~log2(n) * 2^257 (lazy butterfly
    # growth); c must be VALUE-tightened below 2^257 before it can be a
    # spread subtrahend — one mul by R brings it to < p(1+eps)
    c_tight = lm.mont_mul(c_cos, lm.const(FR.one_mont, w.device), FR)
    q = lm.sub_n(lm.mont_mul(a_cos, b_cos, FR), c_tight, FR)
    return lm.from_mont(q, FR)


def assemble_stage(pa, pb1, pb2, pc_partial, r_plain, s_plain,
                   alpha, beta1, beta2):
    """pa/pb1/pc: (B, 63, 1); pb2: (B, 126, 1); r/s: (21, B) plain;
    alpha/beta1 (63, 1), beta2 (126, 1) point planes."""
    def to_lane(x):
        return x[..., 0].transpose(0, 1)                     # -> (rows, B)

    pa, pb1, pc, pb2 = (to_lane(x) for x in (pa, pb1, pc_partial, pb2))
    pi_a = K.padd(pa, alpha, "g1")
    pi_b1 = K.padd(pb1, beta1, "g1")
    pi_b = K.padd(pb2, beta2, "g2")
    s_bits = lm.bits_from_plain(s_plain, 254)               # (254, B)
    r_bits = lm.bits_from_plain(r_plain, 254)
    pi_c = K.padd(pc, K.scalar_mul(pi_a, s_bits, "g1"), "g1")
    pi_c = K.padd(pi_c, K.scalar_mul(pi_b1, r_bits, "g1"), "g1")
    return pi_a, pi_b, pi_c


def neg_rs_scalar(r_plain: torch.Tensor,
                  s_plain: torch.Tensor) -> torch.Tensor:
    """-r*s mod p, plain canonical (21, B)."""
    rs = lm.mont_mul(lm.to_mont(r_plain, FR), s_plain, FR)
    return lm.canon(lm.neg_n(rs, FR), FR)


def draw_rs(seed: int, count: int) -> tuple[np.ndarray, np.ndarray]:
    """r and s for `count` voters as the JAX package's prove_batch draws
    them: numpy.random.default_rng(seed), 31 bytes mod p each, every r
    before every s -> two (21, count) int32 plain limb arrays."""
    rng = np.random.default_rng(seed)
    r_int = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(count)]
    s_int = [int.from_bytes(rng.bytes(31), "big") % P for _ in range(count)]
    return lm.ints_to_lm(r_int), lm.ints_to_lm(s_int)


def input_spec(n_levels: int, batch: int) -> dict:
    """{key: shape} of the int32 arrays that inputs.batch_to_arrays gives
    for `batch` voters at n_levels: scalars (21, B), vectors (k, 21, B),
    siblings (n_levels + 1, 21, B)."""
    one = (lm.N_LIMBS, batch)
    sib = (n_levels + 1, *one)
    return {"electionId": (2, *one), "nullifier": one,
            "availableWeight": one, "voteHash": (2, *one), "sikRoot": one,
            "censusRoot": one, "address": one, "password": one,
            "signature": one, "voteWeight": one, "censusSiblings": sib,
            "sikSiblings": sib}


def _tensor(x) -> torch.Tensor:
    """A tensor as it is, or a CPU tensor over the numpy array's memory."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def check_step_inputs(spec: dict, inputs: dict, r_plain, s_plain) -> None:
    """Raises ValueError unless `inputs` has exactly the keys of `spec`
    (input_spec), each an int32 array or tensor of its shape, and r and s
    are int32 (21, B) with the spec's B."""
    if set(inputs) != set(spec):
        raise ValueError(f"step inputs: keys {sorted(inputs)}, expected "
                         f"{sorted(spec)}")
    batch = spec["address"][-1]
    want = {**spec, "r": (lm.N_LIMBS, batch), "s": (lm.N_LIMBS, batch)}
    got = {**inputs, "r": r_plain, "s": s_plain}
    for key, shape in want.items():
        t = _tensor(got[key])
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"step inputs: {key} is {t.dtype} "
                             f"{tuple(t.shape)}, expected torch.int32 "
                             f"{tuple(shape)}")


def _no_mark(stage: str) -> None:
    pass


@dataclass
class SmtCut:
    """The MSM tables without the SMT levels below `depth`
    (census.smt_cut_vars) and what the step needs to run on them: `index`
    gathers each table's scalars from the full path's ("a": wa, "b": ws
    for B1 and B2, "c": the C scalars); `plans` {table: (chunks, kind)} as
    DeviceProver._msm_plans; `consts` {table: (1, rows, 1)} the cut rows'
    sum times their one witness, added to the table's MSM."""
    depth: int
    index: dict
    plans: dict
    consts: dict


def check_cut_depths(hashed: list, depth: int) -> None:
    """The guard of a step on cut tables: raises unless every lane's count
    of hashed SMT levels (on the card its depth) is at most `depth`."""
    if max(hashed, default=0) > depth:
        raise RuntimeError(f"smt cut: a lane's leaf lies at depth "
                           f"{max(hashed)}, below the cut tables' {depth}: "
                           f"its proof would be wrong")


# the assembly's ladder as plain PyTorch, (rows, B) points and (nbits, B)
# bits: the plain version of K.scalar_mul
scalar_mul_plane = K.scalar_mul_ref


class DeviceProver:
    """Holds the proving-key tables on the device and runs the stages."""

    def __init__(self, circuit: CensusCircuit, pk: ProvingKey,
                 arrays: dict | None = None, *, device=None,
                 window_group: int | None = None):
        """arrays: optional external sparse R1CS arrays; defaults to the
        circuit's own export.  An arrays dict without a C matrix routes
        the quotient through the A/B-only identity (see quotient_stage).

        device: where the tables live and the stages run (default: the
        card; raises if there is none).  window_group: MSM windows per
        group (default: msm_lm.default_window_group, which caps the point
        gather on the card)."""
        self.device = dev = devices.resolve(device)
        self.window_group = window_group
        self.circuit = circuit
        self.pk_meta = (pk.n_vars, pk.n_public, pk.domain)
        cs = circuit.cs
        self.arrays = arrays if arrays is not None else cs.export_arrays(
            extra_rows=qap.binding_rows(cs.num_public))
        assert self.arrays["num_constraints"] <= pk.domain

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        # --- limb-major point tables -------------------------------------
        self.a_tab = t(ec_affine.g1_affine_table(pk.a_g1 + [pk.delta_g1]))
        # compacted B tables (B_i zero <=> both G1/G2 entries are None)
        nz = [i for i, pt in enumerate(pk.b_g1) if pt is not None]
        assert all((pk.b_g2[i] is not None) == (pk.b_g1[i] is not None)
                   for i in range(len(pk.b_g1)))
        self.b_nz = np.asarray(nz + [len(pk.b_g1)], dtype=np.int32)
        self.b1_tab = t(ec_affine.g1_affine_table(
            [pk.b_g1[i] for i in nz] + [pk.delta_g1]))
        self.b2_tab = t(ec_affine.g2_affine_table(
            [pk.b_g2[i] for i in nz] + [pk.delta_g2]))
        self.c_tab = t(ec_affine.g1_affine_table(
            pk.k_g1 + pk.h_g1 + [pk.delta_g1]))
        self.alpha = t(ec_lm.g1_table([pk.alpha_g1]).T)            # (63, 1)
        self.beta1 = t(ec_lm.g1_table([pk.beta_g1]).T)
        self.beta2 = t(ec_lm.g2_table([pk.beta_g2]).T)             # (126, 1)
        self._b_nz_dev = t(self.b_nz.astype(np.int64))

        self._arrays_dev = {
            k: (t(self.arrays[k][0].astype(np.int64)),
                t(self.arrays[k][1].astype(np.int64)),
                t(self.arrays[k][2]))
            for k in ("a", "b", "c") if k in self.arrays}
        # each table's chunks with their [P | -P] rows, built once
        self._msm_plans = {
            key: (msm_lm.plan(tab, kind), kind)
            for key, tab, kind in (("a", self.a_tab, "g1"),
                                   ("b1", self.b1_tab, "g1"),
                                   ("b2", self.b2_tab, "g2"),
                                   ("c", self.c_tab, "g1"))}
        self.cut = self._smt_cut(census.SMT_CUT_DEPTH)

    def _smt_cut(self, depth: int) -> SmtCut | None:
        """The cut tables (SmtCut), None where the circuit has no SMT level
        below `depth`.  The cut rows' witness is the witness generator's
        own for two synthetic voters (census.shallow_voters), checked to be
        one constant (census.cut_witness)."""
        n_levels = self.circuit.n_levels
        wires = census.smt_cut_vars(self.circuit.cs, n_levels, depth)
        if not len(wires):
            return None
        inputs = {k: torch.as_tensor(v, device=self.device) for k, v in
                  census.shallow_voters(n_levels, depth).items()}
        wires_dev = torch.as_tensor(wires, device=self.device)
        w_cut = census.cut_witness(
            lm.from_mont(self.circuit.witness(inputs), FR)[wires_dev],
            n_levels - depth)
        # each table's cut rows and their witness: A's rows are the wires,
        # B's the positions of the cut wires among the B wires, C's the
        # private wires' from npub + 1
        b_pos = np.searchsorted(self.b_nz, wires)
        in_b = self.b_nz[b_pos] == wires
        in_b_dev = torch.as_tensor(in_b, device=self.device)
        cut_rows = {"a": (wires, w_cut), "b1": (b_pos[in_b], w_cut[in_b_dev]),
                    "b2": (b_pos[in_b], w_cut[in_b_dev]),
                    "c": (wires - (self.pk_meta[1] + 1), w_cut)}
        keep, plans, consts = {}, {}, {}
        for key, (chunks, kind) in self._msm_plans.items():
            rows, scalars = cut_rows[key]
            keep[key], chunks, consts[key] = msm_lm.plan_cut(
                getattr(self, f"{key}_tab"), kind, rows, scalars)
            plans[key] = (chunks, kind)

        def t(x):
            return torch.as_tensor(x, device=self.device)

        return SmtCut(depth, {"a": t(keep["a"]), "b": t(self.b_nz[keep["b1"]]),
                              "c": t(keep["c"])}, plans, consts)

    def takes_cut(self, inputs: dict) -> bool:
        """Whether a slice's step runs on the cut tables: the prover has
        them and every lane's leaf lies at or above their depth (read on
        the host from the input arrays)."""
        return self.cut is not None and \
            census.leaves_within(inputs, self.cut.depth)

    def msm_leaves(self, cut: bool) -> dict:
        """The sum-tree leaves a window of the step's four MSMs as planned,
        on the cut tables or the full ones, beside the full ones':
        step.finalize's record."""
        def leaves(plans):
            return sum(msm_lm.plan_leaves(chunks)
                       for chunks, _ in plans.values())
        full = leaves(self._msm_plans)
        return {"msm_leaves": leaves(self.cut.plans) if cut else full,
                "msm_leaves_full": full}

    def msm_rows(self, cut: bool = False) -> dict:
        """{table: (rows, kind)} of the step's four MSMs, on the cut tables
        or the full ones."""
        plans = self.cut.plans if cut else self._msm_plans
        return {key: (sum(real for _, real, _, _ in chunks), kind)
                for key, (chunks, kind) in plans.items()}

    def _msm(self, scalars: torch.Tensor, key: str,
             cut: SmtCut | None = None) -> torch.Tensor:
        """Chunk-dispatched MSM over the proving-key table `key`; with a
        cut, over the cut table (scalars over its rows) plus the cut rows'
        sum."""
        if cut is None:
            chunks, kind = self._msm_plans[key]
            return msm_lm.msm_planned(scalars, chunks, kind,
                                      self.window_group)
        chunks, kind = cut.plans[key]
        return K.padd(msm_lm.msm_planned(scalars, chunks, kind,
                                         self.window_group),
                      cut.consts[key], kind)

    def _inputs(self, inputs: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, device=self.device)
            for k, v in inputs.items()}

    # -- full pipeline -------------------------------------------------------
    def fused_step(self, inputs: dict, r_plain: torch.Tensor,
                   s_plain: torch.Tensor, cut: bool):
        """The whole pipeline as one function: witness, quotient, the four
        MSMs, -r*s and the assembly.  inputs: the dict of
        inputs.batch_to_arrays as int32 tensors, and r/s (21, B) plain
        canonical, all already on the prover's device.  No host copy, no
        synchronisation and no value read back, so it can be captured as
        one CUDA graph (FusedStep).  cut: the MSMs on the cut tables
        (SmtCut), right only where takes_cut(inputs).  Returns (pi_a (63,
        B), pi_b (126, B), pi_c (63, B), publics (npub, 21, B), the SMT
        levels each lane of the two trees hashed (2 B,))."""
        return self._step(inputs, r_plain, s_plain, _no_mark, cut)

    def prove_arrays(self, inputs: dict, r_plain: torch.Tensor,
                     s_plain: torch.Tensor,
                     stage_seconds: dict | None = None,
                     cut: bool | None = None):
        """Batched prove; r/s: (21, B) plain canonical.  Returns limb-major
        planes (pi_a (63, B), pi_b (126, B), pi_c (63, B), publics) and
        the SMT levels hashed, as fused_step.
        Inputs may lie anywhere (numpy arrays or tensors): they are copied
        to the prover's device first; then the body of fused_step runs, on
        the cut tables where `cut` says so (by default where
        takes_cut(inputs)).

        stage_seconds: if a dict is given, the device is synchronized after
        every stage and each stage's seconds are stored in it under
        witness, quotient, msm_a, msm_b1, msm_b2, msm_c, assemble."""
        if cut is None:
            cut = self.takes_cut(inputs)
        clock = _StageClock(stage_seconds, self.device)
        return self._step(self._inputs(inputs), r_plain.to(self.device),
                          s_plain.to(self.device), clock.mark, cut)

    def _step(self, inputs: dict, r_plain, s_plain, mark, cut: bool):
        """The body of fused_step and prove_arrays; mark(stage) is called
        after each stage."""
        if cut and self.cut is None:
            raise ValueError("the prover has no cut tables: its circuit has "
                             "no SMT level below the cut depth")
        cut = self.cut if cut else None
        w, w_plain, hashed = witness_stage(self.circuit, inputs)
        mark("witness")
        q_plain = quotient_stage(self._arrays_dev, self.pk_meta[2], w)
        mark("quotient")

        npub = self.pk_meta[1]
        wa = torch.cat([w_plain, r_plain[None]], 0)
        ws = torch.cat([w_plain, s_plain[None]], 0)
        ws_b = ws[self._b_nz_dev if cut is None else cut.index["b"]]
        pa = self._msm(wa if cut is None else wa[cut.index["a"]], "a", cut)
        mark("msm_a")
        pb1 = self._msm(ws_b, "b1", cut)
        mark("msm_b1")
        pb2 = self._msm(ws_b, "b2", cut)
        mark("msm_b2")
        neg_rs = neg_rs_scalar(r_plain, s_plain)
        c_scalars = torch.cat([w_plain[npub + 1:], q_plain, neg_rs[None]], 0)
        pc = self._msm(c_scalars if cut is None else
                       c_scalars[cut.index["c"]], "c", cut)
        mark("msm_c")
        pi_a, pi_b, pi_c = assemble_stage(pa, pb1, pb2, pc, r_plain, s_plain,
                                          self.alpha, self.beta1, self.beta2)
        mark("assemble")
        # a copy, not a view: a view would keep the whole witness plane
        # alive (a captured step's outputs stay allocated in its pool)
        return pi_a, pi_b, pi_c, w_plain[1:1 + npub].clone(), hashed

    def capture(self, batch: int, *, cut: bool,
                probe=None) -> "FusedStep":
        """fused_step captured as one CUDA graph at this batch size (see
        FusedStep for `cut` and `probe`)."""
        return FusedStep(self, batch, cut=cut, probe=probe)

    # -- host wrapper --------------------------------------------------------
    def prove_batch(self, inputs: dict, seed: int = 0):
        """Returns (proofs: list[Proof], public_signals: list[list[int]]).
        r and s come from numpy.random.default_rng(seed), as in the JAX
        package, so one seed gives the same proofs.  The step runs on the
        cut tables where takes_cut(inputs).  Spans: step.enqueue (r and s
        drawn, the step issued), step.wait (until the device has finished
        it), step.finalize (finish)."""
        with metrics.span("step.enqueue"):
            count = int(np.asarray(inputs["address"]).shape[-1])
            cut = self.takes_cut(inputs)
            r_arr, s_arr = (torch.as_tensor(x, device=self.device)
                            for x in draw_rs(seed, count))
            *planes, hashed = self.prove_arrays(inputs, r_arr, s_arr, cut=cut)
        with metrics.span("step.wait"):
            metrics.force(self.device)
        with metrics.span("step.finalize"):
            return self.finish(planes, hashed, cut)

    def finish(self, planes, hashed: torch.Tensor, cut: bool):
        """step.finalize's body: its record's counts (smt_counts and
        msm_leaves, through metrics.note), the guard of a step on the cut
        tables, then finalize.  The guard reads the hashed levels, which on
        the card are each lane's depth; on the CPU the plain chain hashes
        every level, and takes_cut alone routes."""
        hashed = hashed.cpu()
        metrics.note(**smt_counts(hashed, self.circuit.n_levels),
                     **self.msm_leaves(cut))
        if cut and self.device.type == "cuda":
            check_cut_depths(hashed.tolist(), self.cut.depth)
        return self.finalize(*planes)

    def finalize(self, pa, pb, pc, publics):
        """pa/pc: (63, B); pb: (126, B) planes; publics (8, 21, B) plain
        -> snarkjs-format proofs."""
        a_aff = ec_lm.g1_plane_to_affine(pa)
        b_aff = ec_lm.g2_plane_to_affine(pb)
        c_aff = ec_lm.g1_plane_to_affine(pc)
        npub = self.pk_meta[1]
        B = publics.shape[-1]
        flat = lm.lm_to_ints(publics)               # signal-major: i*B + j
        pubs = [[flat[i * B + j] for i in range(npub)] for j in range(B)]
        proofs = []
        for a, b, c in zip(a_aff, b_aff, c_aff):
            proofs.append(Proof({
                "pi_a": [str(a[0]), str(a[1]), "1"],
                "pi_b": [[str(b[0][0]), str(b[0][1])],
                         [str(b[1][0]), str(b[1][1])], ["1", "0"]],
                "pi_c": [str(c[0]), str(c[1]), "1"],
            }))
        return proofs, pubs


class FusedStep:
    """DeviceProver.fused_step captured as one CUDA graph at one batch size.

    Static buffers hold the inputs (one per key of input_spec, int32), r
    and s.  At construction fused_step runs once eagerly on them on a side
    stream (building the kernels and filling the lazy device constants),
    then once under torch.cuda.graph.  A call checks its inputs, copies
    them into the buffers, replays the graph and returns clones of the
    outputs, which the next replay cannot overwrite.  A replay ticks no
    launch counter: `launches` holds what the capture launched, by kernel.
    There is no eager fallback: a prover off the card, a failed capture or
    a mismatched input raises.

    pool: a torch.cuda.graph_pool_handle() that the capture allocates
    from, shared with other graphs (default: a pool of its own).  The
    buffers and the lazy device constants lie outside it; the graph keeps
    only its outputs alive in it, and another graph of a shared pool may
    use their space when it replays (ReplayProver).  probe(stage), if
    given, is called before the warm-up ("start") and after the warm-up,
    the capture and the instantiation ("warmup", "capture",
    "instantiate"), so a caller can read the allocator at each point.

    cut: the step on the prover's cut tables (SmtCut), or on the full
    ones.  A cut step refuses inputs with a leaf below the
    cut depth (DeviceProver.takes_cut), and its prove_batch checks the
    depths the witness reports (DeviceProver.finish)."""

    def __init__(self, prover: DeviceProver, batch: int, *, cut: bool,
                 pool=None, probe=None):
        dev = prover.device
        if dev.type != "cuda":
            raise RuntimeError(f"FusedStep: a CUDA graph needs a prover on "
                               f"the card, not on {dev}")
        probe = probe or _no_mark
        self.prover = prover
        self.batch = batch
        self.pool = pool
        self.cut = cut
        self.spec = input_spec(prover.circuit.n_levels, batch)
        self.inputs = {k: torch.zeros(shape, dtype=torch.int32, device=dev)
                       for k, shape in self.spec.items()}
        self.r = torch.zeros((lm.N_LIMBS, batch), dtype=torch.int32,
                             device=dev)
        self.s = torch.zeros_like(self.r)

        probe("start")
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prover.fused_step(self.inputs, self.r, self.s, self.cut)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        probe("warmup")

        before = dict(K.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = prover.fused_step(self.inputs, self.r, self.s,
                                             self.cut)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: v - before[k] for k, v in K.LAUNCHES.items()
                         if v != before[k]}
        probe("capture")
        t0 = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0
        probe("instantiate")

    def __call__(self, inputs: dict, r_plain, s_plain):
        """-> clones of (pi_a, pi_b, pi_c, publics, hashed) for these
        inputs."""
        check_step_inputs(self.spec, inputs, r_plain, s_plain)
        if self.cut and not self.prover.takes_cut(inputs):
            raise ValueError(f"step inputs: a leaf below depth "
                             f"{self.prover.cut.depth}, on a step on the "
                             f"cut tables")
        for key, buf in self.inputs.items():
            buf.copy_(_tensor(inputs[key]))
        self.r.copy_(_tensor(r_plain))
        self.s.copy_(_tensor(s_plain))
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)

    def prove_batch(self, inputs: dict, seed: int = 0):
        """DeviceProver.prove_batch through the graph: the same r and s
        from the same seed, so the same proofs, and the same spans
        (step.enqueue: r and s drawn, the inputs checked and copied in,
        the replay and the clones)."""
        with metrics.span("step.enqueue"):
            r_arr, s_arr = draw_rs(seed, self.batch)
            *planes, hashed = self(inputs, r_arr, s_arr)
        with metrics.span("step.wait"):
            metrics.force(self.prover.device)
        with metrics.span("step.finalize"):
            return self.prover.finish(planes, hashed, self.cut)

    def node_counts(self) -> dict:
        """{node type: count} of the captured graph (graph_node_counts)."""
        return graph_node_counts(self.graph)


class ReplayProver:
    """A DeviceProver behind one captured step per batch size: the port's
    counterpart of the JAX prover's programs compiled once per shape.

    ProofStream's duck type (.circuit, .device, prove_batch).  step(B,
    cut) captures a FusedStep the first time size B is asked for on the
    cut tables (cut True) or the full ones, and keeps it; prove_batch
    replays the one its slice takes (DeviceProver.takes_cut) with the r
    and s that DeviceProver.prove_batch draws from the same seed, so the
    proofs are the same.  Every step is captured into one memory pool
    (one torch.cuda.graph_pool_handle()), so the steps share the space of
    their intermediates.  A later capture
    may place its outputs where an earlier graph keeps intermediates, so
    a graph's outputs hold only until the next replay of any size; each
    call clones them right after its own replay, on the same stream,
    which makes any order of replays safe (never two at once).  There is
    no eager or CPU fallback: a prover off the card or a failed capture
    raises, and a size with no graph is captured, never run eagerly.
    `steps` holds the steps by (size, cut) in the order they were
    captured."""

    def __init__(self, prover: DeviceProver, probe=None):
        """probe(batch, stage), if given, is called at every FusedStep
        probe point of each capture."""
        if prover.device.type != "cuda":
            raise RuntimeError(f"ReplayProver: CUDA graphs need a prover on "
                               f"the card, not on {prover.device}")
        self.prover = prover
        self.circuit, self.device = prover.circuit, prover.device
        self.pool = torch.cuda.graph_pool_handle()
        self.probe = probe
        self.steps: dict = {}

    def step(self, batch: int, cut: bool = True) -> FusedStep:
        """The captured step of this batch size, captured at first use: on
        the cut tables where `cut` asks for them and the prover has them
        (the default, what a stream's set-up captures ahead of its
        slices), else on the full ones."""
        cut = cut and self.prover.cut is not None
        if (batch, cut) not in self.steps:
            probe = self.probe and (lambda stage: self.probe(batch, stage))
            self.steps[batch, cut] = FusedStep(
                self.prover, batch, cut=cut, pool=self.pool, probe=probe)
        return self.steps[batch, cut]

    def prove_batch(self, inputs: dict, seed: int = 0):
        """DeviceProver.prove_batch through the step of this batch size on
        the tables the slice takes."""
        batch = int(np.asarray(inputs["address"]).shape[-1])
        return self.step(batch, self.prover.takes_cut(inputs)).prove_batch(
            inputs, seed=seed)


# CUgraphNodeType (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _cu_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUresult {rc}")


def graph_node_counts(graph) -> dict:
    """{node type: count} of a torch.cuda.CUDAGraph captured with
    keep_graph=True, read through libcuda (cuGraphGetNodes,
    cuGraphNodeGetType)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu_check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)),
              "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
    out: dict = {}
    kind = ctypes.c_int(0)
    for node in nodes:
        _cu_check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)),
                  "cuGraphNodeGetType")
        name = _NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


class _StageClock:
    """Records seconds per stage when given a dict; does nothing else."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out = out
        self.device = device
        if out is not None:
            self._sync()
            self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        self._sync()
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now
