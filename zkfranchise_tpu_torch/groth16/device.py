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
replays it as one CUDA graph at a fixed batch.

The B1/B2 tables are compacted: wires whose B polynomial is zero carry
identity points (None in the key), and dropping them roughly halves the
padded MSM size.
"""
from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ..models.census import CensusCircuit
from ..ops import ec_affine, ec_lm, ff, lm, msm_lm, ntt, sparse
from ..ops.cuda import lm_kernels as K
from ..ops.lm import FR
from ..utils import devices
from . import qap
from .setup import ProvingKey
from .verify import Proof

P = ff.P_FR


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def witness_stage(circuit: CensusCircuit, inputs: dict):
    """-> (w Montgomery (num_vars, 21, B), w plain canonical)."""
    w = circuit.witness(inputs)
    return w, lm.from_mont(w, FR)


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
        self._msm_plans = {}
        for key, tab, kind in (("a", self.a_tab, "g1"),
                               ("b1", self.b1_tab, "g1"),
                               ("b2", self.b2_tab, "g2"),
                               ("c", self.c_tab, "g1")):
            plan = msm_lm._chunks(tab.shape[0])
            tabs = [msm_lm.pad_chunk(None, tab, s, r, m, kind)[1]
                    for (s, r, m) in plan]
            self._msm_plans[key] = (plan, tabs, kind)

    def _msm(self, scalars: torch.Tensor, key: str) -> torch.Tensor:
        """Chunk-dispatched MSM over the proving-key table `key`."""
        plan, tabs, kind = self._msm_plans[key]
        ws = [msm_lm.chunk_window_sums(
            msm_lm.pad_chunk(scalars, None, s, r, m, kind)[0], tab, kind,
            self.window_group)
            for (s, r, m), tab in zip(plan, tabs)]
        return msm_lm.combine_horner(ws, kind, scalars.shape[-1])

    def _inputs(self, inputs: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, device=self.device)
            for k, v in inputs.items()}

    # -- full pipeline -------------------------------------------------------
    def fused_step(self, inputs: dict, r_plain: torch.Tensor,
                   s_plain: torch.Tensor):
        """The whole pipeline as one function: witness, quotient, the four
        MSMs, -r*s and the assembly.  inputs: the dict of
        inputs.batch_to_arrays as int32 tensors, and r/s (21, B) plain
        canonical, all already on the prover's device.  No host copy, no
        synchronisation and no value read back, so it can be captured as
        one CUDA graph (FusedStep).  Returns (pi_a (63, B), pi_b (126, B),
        pi_c (63, B), publics (npub, 21, B))."""
        return self._step(inputs, r_plain, s_plain, _no_mark)

    def prove_arrays(self, inputs: dict, r_plain: torch.Tensor,
                     s_plain: torch.Tensor,
                     stage_seconds: dict | None = None):
        """Batched prove; r/s: (21, B) plain canonical.  Returns limb-major
        planes (pi_a (63, B), pi_b (126, B), pi_c (63, B), publics).
        Inputs may lie anywhere (numpy arrays or tensors): they are copied
        to the prover's device first; then the body of fused_step runs.

        stage_seconds: if a dict is given, the device is synchronized after
        every stage and each stage's seconds are stored in it under
        witness, quotient, msm_a, msm_b1, msm_b2, msm_c, assemble."""
        clock = _StageClock(stage_seconds, self.device)
        return self._step(self._inputs(inputs), r_plain.to(self.device),
                          s_plain.to(self.device), clock.mark)

    def _step(self, inputs: dict, r_plain, s_plain, mark):
        """The body of fused_step and prove_arrays; mark(stage) is called
        after each stage."""
        w, w_plain = witness_stage(self.circuit, inputs)
        mark("witness")
        q_plain = quotient_stage(self._arrays_dev, self.pk_meta[2], w)
        mark("quotient")

        npub = self.pk_meta[1]
        wa = torch.cat([w_plain, r_plain[None]], 0)
        ws = torch.cat([w_plain, s_plain[None]], 0)
        ws_b = ws[self._b_nz_dev]
        pa = self._msm(wa, "a")
        mark("msm_a")
        pb1 = self._msm(ws_b, "b1")
        mark("msm_b1")
        pb2 = self._msm(ws_b, "b2")
        mark("msm_b2")
        neg_rs = neg_rs_scalar(r_plain, s_plain)
        c_scalars = torch.cat([w_plain[npub + 1:], q_plain, neg_rs[None]], 0)
        pc = self._msm(c_scalars, "c")
        mark("msm_c")
        pi_a, pi_b, pi_c = assemble_stage(pa, pb1, pb2, pc, r_plain, s_plain,
                                          self.alpha, self.beta1, self.beta2)
        mark("assemble")
        return pi_a, pi_b, pi_c, w_plain[1:1 + npub]

    def capture(self, batch: int) -> "FusedStep":
        """fused_step captured as one CUDA graph at this batch size."""
        return FusedStep(self, batch)

    # -- host wrapper --------------------------------------------------------
    def prove_batch(self, inputs: dict, seed: int = 0):
        """Returns (proofs: list[Proof], public_signals: list[list[int]]).
        r and s come from numpy.random.default_rng(seed), as in the JAX
        package, so one seed gives the same proofs."""
        count = int(np.asarray(inputs["address"]).shape[-1])
        r_arr, s_arr = (torch.as_tensor(x, device=self.device)
                        for x in draw_rs(seed, count))
        pa, pb, pc, publics = self.prove_arrays(inputs, r_arr, s_arr)
        return self.finalize(pa, pb, pc, publics)

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
    a mismatched input raises."""

    def __init__(self, prover: DeviceProver, batch: int):
        dev = prover.device
        if dev.type != "cuda":
            raise RuntimeError(f"FusedStep: a CUDA graph needs a prover on "
                               f"the card, not on {dev}")
        self.prover = prover
        self.batch = batch
        self.spec = input_spec(prover.circuit.n_levels, batch)
        self.inputs = {k: torch.zeros(shape, dtype=torch.int32, device=dev)
                       for k, shape in self.spec.items()}
        self.r = torch.zeros((lm.N_LIMBS, batch), dtype=torch.int32,
                             device=dev)
        self.s = torch.zeros_like(self.r)

        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prover.fused_step(self.inputs, self.r, self.s)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0

        before = dict(K.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.outputs = prover.fused_step(self.inputs, self.r, self.s)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: v - before[k] for k, v in K.LAUNCHES.items()
                         if v != before[k]}
        t0 = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0

    def __call__(self, inputs: dict, r_plain, s_plain):
        """-> clones of (pi_a, pi_b, pi_c, publics) for these inputs."""
        check_step_inputs(self.spec, inputs, r_plain, s_plain)
        for key, buf in self.inputs.items():
            buf.copy_(_tensor(inputs[key]))
        self.r.copy_(_tensor(r_plain))
        self.s.copy_(_tensor(s_plain))
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)

    def prove_batch(self, inputs: dict, seed: int = 0):
        """DeviceProver.prove_batch through the graph: the same r and s
        from the same seed, so the same proofs."""
        r_arr, s_arr = draw_rs(seed, self.batch)
        return self.prover.finalize(*self(inputs, r_arr, s_arr))

    def node_counts(self) -> dict:
        """{node type: count} of the captured graph, read through libcuda
        (cuGraphGetNodes, cuGraphNodeGetType)."""
        cuda = ctypes.CDLL("libcuda.so.1")
        graph = ctypes.c_void_p(self.graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        _cu_check(cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)),
                  "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _cu_check(cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
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


# CUgraphNodeType (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _cu_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUresult {rc}")


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
