"""Sharded Groth16 proving step over a (data, model) mesh of ranks.

Parallel decomposition, as in the JAX package's parallel/prove.py:
  * the voter batch is split over 'data': it rides the LANE axis of every
    limb plane, so witness generation, R1CS rows, the NTT and the quotient
    are lane-parallel;
  * R1CS rows and the coset NTT DOMAIN are split over 'model': each rank
    evaluates its row range of az/bz/cz (nonzeros partitioned once, when
    the prover is built) and the three coset transforms run as the
    distributed four-step NTT (ops/ntt_dist.py), when nm > 1 and
    nm^2 | n; otherwise the quotient runs whole on every rank;
  * the MSM point tables are split over 'model' (leading axis): each rank
    runs the MSM of its slice of the proving key; the partial points are
    all-gathered and added in a tree (EC addition is not a sum the
    collectives can do, so the combine is a gather and a reduction).

The stage math is the single-device prover's: witness_stage,
quotient_stage, the MSM of ops/msm_lm.py and assemble_stage come from
groth16/device.py.  A rank keeps only its model shard of the four point
tables, its row shard of A/B/C and its slice of the NTT plan.  The
reduction order is the JAX package's (gather order by model index, then
pairwise adds with an identity pad on odd counts), so the planes equal
its ShardedProver's limb for limb.

Every rank of the mesh runs the same steps on its own shards.  The
JAX package compiles the whole sharded step as one program, collectives
inside, and its ``compile_only`` builds that program ahead of time.
Here ``ShardedProver.capture`` is the counterpart: ``ShardedStep``
captures the step on each rank as CUDA graphs, one per stretch between
its collectives, and replays them with the collectives run between the
graphs (gloo collectives cannot be recorded into a graph, and NCCL
refuses two ranks of one communicator on one card).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from ..groth16 import qap
from ..groth16.device import (DeviceProver, _StageClock, _tensor,
                              assemble_stage, check_step_inputs, draw_rs,
                              graph_node_counts, input_spec, neg_rs_scalar,
                              quotient_stage, witness_stage)
from ..models.census import CensusCircuit
from ..ops import ec_affine, ec_lm, lm, msm_lm, ntt_dist, sparse
from ..ops.cuda import lm_kernels as K
from ..ops.lm import FR, N_LIMBS
from .mesh import Mesh
from .runtime import local_shard


def _shard_rows(arr, n: int, nm: int):
    """Partition one R1CS nonzero list by row range for nm ranks.
    arr: (rows, cols, coeffs (nnz, 21, 1)); returns (R, C, F) with a
    leading nm axis, nnz padded to the largest shard (pad entries have
    coefficient 0 and add nothing to row 0), rows RELATIVE to the shard's
    base.  Entries keep their order within a shard."""
    rows, cols, coeffs = (np.asarray(a) for a in arr)
    b = n // nm
    shard = rows.astype(np.int64) // b
    counts = np.bincount(shard, minlength=nm)
    nnz = max(int(counts.max(initial=0)), 1)
    order = np.argsort(shard, kind="stable")
    sh = shard[order]
    pos = np.arange(len(rows)) - np.repeat(
        np.cumsum(counts) - counts, counts)
    R = np.zeros((nm, nnz), np.int32)
    C = np.zeros((nm, nnz), np.int32)
    F = np.zeros((nm, nnz, N_LIMBS, 1), np.int32)
    R[sh, pos] = rows[order] - sh * b
    C[sh, pos] = cols[order]
    F[sh, pos] = coeffs[order]
    return R, C, F


def _spmv_local(R, C, F, b: int, w: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the R1CS matvec: (b, 21, T) Montgomery (a
    gather, mont_mul, a segment sum, weak_norm: ops/sparse.py)."""
    return sparse.spmv(R, C, F, b, w)


def _table_shard(points: list, nm: int, index: int, kind: str) -> np.ndarray:
    """Rows [index * s, (index + 1) * s) of the affine table of `points`
    padded with identity rows to a multiple of nm (s = padded / nm): the
    JAX package's _pad_table, then its model shard."""
    s = -(-len(points) // nm)
    piece = ec_affine.affine_table(points[index * s:(index + 1) * s], kind)
    if piece.shape[0] < s:
        piece = np.concatenate(
            [piece, ec_affine.identity_rows(kind, s - piece.shape[0])], 0)
    return piece


def _tree_reduce_axis0(pts: torch.Tensor, kind: str) -> torch.Tensor:
    """(S, B, rows, 1) gathered partials -> (B, rows, 1) group sum."""
    while pts.shape[0] > 1:
        if pts.shape[0] % 2:
            pad = ec_lm.identity_plane(kind, (1, *pts.shape[1:-2]), 1,
                                       pts.device)
            pts = torch.cat([pts, pad], 0)
        pts = K.padd(pts[0::2], pts[1::2], kind)
    return pts[0]


def _sharded_msm(scalars_full: torch.Tensor, tab_shard: torch.Tensor,
                 kind: str, shard_size: int, axis) -> torch.Tensor:
    """scalars_full: (n_padded, 21, B), the same on every member of
    `axis`; tab_shard: (n_padded / axis.size, arows) this rank's slice of
    the table.  Returns the whole MSM, the same on every member."""
    i = axis.index
    partial = msm_lm.msm(scalars_full[i * shard_size:(i + 1) * shard_size],
                         tab_shard, kind)                  # (B, rows, 1)
    return _tree_reduce_axis0(axis.all_gather(partial), kind)


# the inputs' split: every leaf's LAST axis is the voter batch
_IN_RANKS = {"electionId": 3, "voteHash": 3, "censusSiblings": 3,
             "sikSiblings": 3}


def _in_spec(key: str) -> tuple:
    return (None,) * (_IN_RANKS.get(key, 2) - 1) + ("data",)


def local_input_spec(n_levels: int, batch: int, n_data: int) -> dict:
    """{key: shape} of one rank's lanes of input_spec(n_levels, batch)
    under _in_spec: the last (voter) axis cut n_data ways."""
    if batch % n_data:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{n_data} data ranks")
    return {k: (*shape[:-1], shape[-1] // n_data)
            for k, shape in input_spec(n_levels, batch).items()}


def _pad0(s: torch.Tensor, total: int) -> torch.Tensor:
    return torch.cat([s, s.new_zeros((total - s.shape[0], N_LIMBS,
                                      s.shape[-1]))], 0)


def _no_mark(stage: str) -> None:
    pass


class ShardedProver:
    """Batched prover on one rank of a mesh: voter lanes over 'data',
    proving-key tables, R1CS rows and the NTT domain over 'model'.  Its
    MSMs always run on the full tables: it has no counterpart of
    DeviceProver's cut tables (groth16/device.py SmtCut), which leave out
    the SMT levels below census.SMT_CUT_DEPTH."""

    def __init__(self, circuit: CensusCircuit, pk, mesh: Mesh):
        self.circuit = circuit
        self.mesh = mesh
        self.device = dev = mesh.device
        self.n_model = nm = mesh.model.size
        mi = mesh.model.index
        cs = circuit.cs
        self.arrays = cs.export_arrays(
            extra_rows=qap.binding_rows(cs.num_public))
        self.pk_meta = (pk.n_vars, pk.n_public, pk.domain)
        n = pk.domain

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        # domain sharding for the quotient (four-step needs nm^2 | n; else
        # every rank runs the whole transform)
        self._dist_ntt = nm > 1 and n % (nm * nm) == 0
        if self._dist_ntt:
            self._ntt_plan = ntt_dist.plan(n.bit_length() - 1, nm)
            self._ntt_plan.on(str(dev), mi)
            self._row_shards = {}
            for k in ("a", "b", "c"):
                R, C, F = _shard_rows(self.arrays[k], n, nm)
                self._row_shards[k] = (t(R[mi].astype(np.int64)),
                                       t(C[mi].astype(np.int64)), t(F[mi]))
        else:
            self._arrays_dev = {
                k: (t(self.arrays[k][0].astype(np.int64)),
                    t(self.arrays[k][1].astype(np.int64)),
                    t(self.arrays[k][2])) for k in ("a", "b", "c")}

        nz = [i for i, pt in enumerate(pk.b_g1) if pt is not None]
        self.b_nz = np.asarray(nz + [len(pk.b_g1)], dtype=np.int32)
        self._b_nz_dev = t(self.b_nz.astype(np.int64))
        points = {
            "a": (pk.a_g1 + [pk.delta_g1], "g1"),
            "b1": ([pk.b_g1[i] for i in nz] + [pk.delta_g1], "g1"),
            "b2": ([pk.b_g2[i] for i in nz] + [pk.delta_g2], "g2"),
            "c": (pk.k_g1 + pk.h_g1 + [pk.delta_g1], "g1")}
        # this rank's table shards, the padded length of each whole table,
        # and each shard's MSM chunks (as DeviceProver._msm_plans)
        self.tabs, self.padded, self._msm_plans = {}, {}, {}
        for key, (pts, kind) in points.items():
            tab = t(_table_shard(pts, nm, mi, kind))
            self.tabs[key] = tab
            self.padded[key] = tab.shape[0] * nm
            self._msm_plans[key] = (msm_lm.plan(tab, kind), kind)
        self.alpha = t(ec_lm.g1_table([pk.alpha_g1]).T)
        self.beta1 = t(ec_lm.g1_table([pk.beta_g1]).T)
        self.beta2 = t(ec_lm.g2_table([pk.beta_g2]).T)

    # -- stages ---------------------------------------------------------------
    def _msm(self, scalars_full: torch.Tensor, key: str) -> torch.Tensor:
        """The MSM of this rank's shard of table `key` over its slice of
        the scalars, gathered over 'model' and reduced."""
        chunks, kind = self._msm_plans[key]
        s = self.tabs[key].shape[0]
        i = self.mesh.model.index
        partial = msm_lm.msm_planned(scalars_full[i * s:(i + 1) * s], chunks,
                                     kind)
        return _tree_reduce_axis0(self.mesh.model.all_gather(partial), kind)

    def _quotient(self, w: torch.Tensor) -> torch.Tensor:
        """Coset quotient evals, plain canonical (n, 21, T), whole on every
        rank."""
        n = self.pk_meta[2]
        if not self._dist_ntt:
            return quotient_stage(self._arrays_dev, n, w)
        axis, plan = self.mesh.model, self._ntt_plan
        b = n // self.n_model
        a_cos, b_cos, c_cos = (
            ntt_dist.coset_evals_dist(
                _spmv_local(*self._row_shards[k], b, w), axis, plan)
            for k in ("a", "b", "c"))
        # see groth16.device.quotient_stage: tighten c below 2^257
        c_tight = lm.mont_mul(c_cos, lm.const(FR.one_mont, w.device), FR)
        q_local = lm.sub_n(lm.mont_mul(a_cos, b_cos, FR), c_tight, FR)
        # the all-gather, tiled: member c's rows [c*b, (c+1)*b) in turn
        return axis.all_gather(lm.from_mont(q_local, FR)).reshape(
            n, N_LIMBS, w.shape[-1])

    def _step(self, inputs: dict, r_plain, s_plain, mark):
        npub = self.pk_meta[1]
        w, w_plain, _ = witness_stage(self.circuit, inputs)
        mark("witness")
        q_plain = self._quotient(w)
        mark("quotient")
        wa = _pad0(torch.cat([w_plain, r_plain[None]], 0), self.padded["a"])
        ws = torch.cat([w_plain, s_plain[None]], 0)
        ws_b = _pad0(ws[self._b_nz_dev], self.padded["b1"])
        pa = self._msm(wa, "a")
        mark("msm_a")
        pb1 = self._msm(ws_b, "b1")
        mark("msm_b1")
        pb2 = self._msm(ws_b, "b2")
        mark("msm_b2")
        neg_rs = neg_rs_scalar(r_plain, s_plain)
        c_scal = _pad0(torch.cat([w_plain[npub + 1:], q_plain,
                                  neg_rs[None]], 0), self.padded["c"])
        pc = self._msm(c_scal, "c")
        mark("msm_c")
        pi_a, pi_b, pi_c = assemble_stage(pa, pb1, pb2, pc, r_plain, s_plain,
                                          self.alpha, self.beta1, self.beta2)
        mark("assemble")
        # a copy, not a view: a view would keep the whole witness plane
        # alive (a captured step's outputs stay allocated in its pool)
        return pi_a, pi_b, pi_c, w_plain[1:1 + npub].clone()

    # -- entry points on this rank's lanes ------------------------------------
    def prove_fused(self, inputs: dict, r_plain: torch.Tensor,
                    s_plain: torch.Tensor):
        """The whole step on this rank's lanes: inputs (the dict of
        inputs.batch_to_arrays, this rank's lanes) and r/s (21, B_local)
        plain canonical, all on the rank's device.  No host copy and no
        synchronisation of its own (gloo's collectives move CUDA tensors
        through host memory themselves).  Returns (pi_a (63, B_local), pi_b
        (126, B_local), pi_c (63, B_local), publics (npub, 21, B_local))."""
        return self._step(inputs, r_plain, s_plain, _no_mark)

    def prove_batch_arrays(self, inputs: dict, r_plain, s_plain,
                           stage_seconds: dict | None = None):
        """prove_fused stage by stage; inputs, r and s (this rank's lanes)
        may lie anywhere and are copied to the device first.

        stage_seconds: if a dict is given, the device is synchronized after
        every stage and around every collective; it receives each stage's
        seconds under witness, quotient, msm_a, msm_b1, msm_b2, msm_c,
        assemble, and under "<stage>/collective_s" and
        "<stage>/collective_bytes" the seconds and the bytes sent to other
        ranks of that stage's collectives."""
        def on(x):
            return _tensor(x).to(self.device)

        clock = _MeshClock(stage_seconds, self.mesh)
        try:
            return self._step({k: on(v) for k, v in inputs.items()},
                              on(r_plain), on(s_plain), clock.mark)
        finally:
            clock.close()

    # -- host wrapper ---------------------------------------------------------
    def prove_batch(self, inputs: dict, seed: int = 0):
        """The whole batch's host inputs (the same on every rank) -> this
        rank's voters' (proofs, public signals).  r and s are drawn for the
        whole batch as DeviceProver.prove_batch draws them, then each rank
        takes its lanes, so one seed gives the single-device prover's
        proofs."""
        count = int(np.asarray(inputs["address"]).shape[-1])
        local = {k: local_shard(v, self.mesh, _in_spec(k))
                 for k, v in inputs.items()}
        return self.finalize(*self.prove_fused(
            local, *self.local_rs(seed, count)))

    def local_rs(self, seed: int, count: int) -> tuple:
        """r and s of prove_batch(seed) for a batch of `count`: this rank's
        lanes on its device."""
        return tuple(local_shard(x, self.mesh, (None, "data"))
                     for x in draw_rs(seed, count))

    def capture(self, batch: int, probe=None) -> "ShardedStep":
        """prove_fused captured on this rank for a whole batch of `batch`
        voters, one CUDA graph a stretch between collectives (see
        ShardedStep for `probe`).  Every rank of the mesh must call it."""
        return ShardedStep(self, batch, probe=probe)

    # planes -> snarkjs-format proofs, as the single-device prover does
    finalize = DeviceProver.finalize


class ShardedStep:
    """ShardedProver.prove_fused captured on one rank as CUDA graphs, one
    per stretch between its collectives: the counterpart of the JAX
    package's compiled sharded step (``prove_fused(..., compile_only=
    True)``), and the sharded twin of groth16.device.FusedStep.

    Static buffers hold this rank's lanes of the inputs (local_input_spec)
    and of r and s.  At construction prove_fused runs once eagerly on
    them on a side stream, collectives included, filling the lazy device
    constants; every rank of the mesh must construct its step together.
    Then prove_fused runs again with the mesh hooked: every stretch is
    captured into one memory pool (torch.cuda.graph_pool_handle(),
    capture_error_mode="thread_local"), and at each collective the
    capture ends, the call is kept (op, axis, input, output buffers)
    without running it, and the next stretch's capture begins.  So a step
    of k collectives has k + 1 graphs, cut at the same calls in the same
    order on every rank.  The graphs are instantiated, then the ranks meet
    at a barrier on the mesh.

    A call checks its inputs, copies them into the buffers, replays graph
    0, runs collective 0 on its kept buffers, replays graph 1, and so on,
    and returns clones of the outputs.  The graphs share one pool and
    always replay in capture order, never two at once; the tensors that
    cross a cut (the collectives' inputs and outputs, and the outputs)
    stay referenced by the step.  A replay ticks no launch counter:
    `launches` holds what the capture launched, by kernel, summed over
    the stretches, and `eager_launches` what the warm-up launched.  There
    is no eager fallback: a mesh off the card, a failed capture or a
    mismatched input raises.

    probe(stage), if given, is called before the warm-up ("start") and
    after the warm-up, the capture and the instantiation ("warmup",
    "capture", "instantiate")."""

    def __init__(self, prover: ShardedProver, batch: int, *, probe=None):
        dev = prover.device
        if dev.type != "cuda":
            raise RuntimeError(f"ShardedStep: CUDA graphs need a mesh on "
                               f"the card, not on {dev}")
        probe = probe or _no_mark
        mesh = prover.mesh
        self.prover = prover
        self.batch = batch
        self.spec = local_input_spec(prover.circuit.n_levels, batch,
                                     mesh.data.size)
        self.inputs = {k: torch.zeros(shape, dtype=torch.int32, device=dev)
                       for k, shape in self.spec.items()}
        self.r = torch.zeros(self.spec["address"], dtype=torch.int32,
                             device=dev)
        self.s = torch.zeros_like(self.r)

        probe("start")
        t0 = time.perf_counter()
        before = dict(K.LAUNCHES)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prover.prove_fused(self.inputs, self.r, self.s)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.eager_launches = _launched_since(before)
        self.warmup_s = time.perf_counter() - t0
        probe("warmup")

        # as torch.cuda.graph does before a capture: no warm-up block
        # outlives it
        gc.collect()
        torch.cuda.empty_cache()
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.collectives: list = []
        self._open = False
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), mesh.hooked(self._cut):
            self._begin()
            try:
                self.outputs = prover.prove_fused(self.inputs, self.r,
                                                  self.s)
            except BaseException:
                self._abandon()
                raise
            self._end()
        self.capture_s = time.perf_counter() - t0
        self.launches = _launched_since(before)
        probe("capture")
        t0 = time.perf_counter()
        for graph in self.graphs:
            graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t0
        probe("instantiate")
        mesh.barrier()

    # -- the segmented capture: a graph a stretch, cut at each collective --
    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graphs.append(graph)
        self._open = True

    def _end(self) -> None:
        self._open = False
        self.graphs[-1].capture_end()

    def _cut(self, c) -> None:
        """The mesh's hook while recording: end this stretch's graph, keep
        the collective without running it, begin the next graph."""
        self._end()
        self.collectives.append(c)
        self._begin()

    def _abandon(self) -> None:
        """Ends an open capture after a failure; the failure is the error
        to report, not what ending the broken capture raises."""
        if self._open:
            with contextlib.suppress(RuntimeError):
                self._end()

    @property
    def stretches(self) -> int:
        return len(self.graphs)

    def schedule(self) -> list:
        """(op, axis, input shape, dtype) of each collective, in order."""
        return [c.signature() for c in self.collectives]

    def __call__(self, inputs: dict, r_plain, s_plain):
        """This rank's lanes (as prove_fused takes them) -> clones of
        (pi_a, pi_b, pi_c, publics).  Every rank of the mesh must call it
        together."""
        check_step_inputs(self.spec, inputs, r_plain, s_plain)
        for key, buf in self.inputs.items():
            buf.copy_(_tensor(inputs[key]))
        self.r.copy_(_tensor(r_plain))
        self.s.copy_(_tensor(s_plain))
        for graph, c in zip(self.graphs, self.collectives):
            graph.replay()
            c.run()
        self.graphs[-1].replay()
        return tuple(o.clone() for o in self.outputs)

    def prove_batch(self, inputs: dict, seed: int = 0):
        """ShardedProver.prove_batch through the graphs: the whole batch's
        host inputs (the same on every rank), r and s drawn from the seed
        for the whole batch, this rank's lanes -> its voters' (proofs,
        public signals), the eager step's and the single device's."""
        count = int(np.asarray(inputs["address"]).shape[-1])
        if count != self.batch:
            raise ValueError(f"step inputs: a batch of {count}, the step "
                             f"was captured for {self.batch}")
        mesh = self.prover.mesh
        local = {k: local_shard(v, mesh, _in_spec(k))
                 for k, v in inputs.items()}
        return self.prover.finalize(
            *self(local, *self.prover.local_rs(seed, count)))

    def node_counts(self) -> dict:
        """{node type: count} summed over the stretches' graphs."""
        out: dict = {}
        for counts in self.node_counts_by_stretch():
            for k, v in counts.items():
                out[k] = out.get(k, 0) + v
        return out

    def node_counts_by_stretch(self) -> list:
        return [graph_node_counts(g) for g in self.graphs]


def _launched_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()
            if v != before.get(k, 0)}


class _MeshClock(_StageClock):
    """The single device's stage clock, and each stage's collective
    seconds and bytes beside its seconds."""

    def __init__(self, out: dict | None, mesh: Mesh):
        super().__init__(out, mesh.device)
        self.stats = mesh.stats
        if out is not None:
            self.stats.timing = True
            self.c = self.stats.snapshot()

    def mark(self, name: str) -> None:
        if self.out is None:
            return
        super().mark(name)
        c = self.stats.snapshot()
        self.out[name + "/collective_s"] = c[2] - self.c[2]
        self.out[name + "/collective_bytes"] = c[1] - self.c[1]
        self.c = c

    def close(self) -> None:
        self.stats.timing = False
