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

Every rank of the mesh runs the same steps on its own shards.  Eager
PyTorch compiles nothing ahead of time, so the JAX prover's
``compile_only`` has no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..groth16 import qap
from ..groth16.device import (DeviceProver, _StageClock, _tensor,
                              assemble_stage, draw_rs, neg_rs_scalar,
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


def _pad0(s: torch.Tensor, total: int) -> torch.Tensor:
    return torch.cat([s, s.new_zeros((total - s.shape[0], N_LIMBS,
                                      s.shape[-1]))], 0)


def _no_mark(stage: str) -> None:
    pass


class ShardedProver:
    """Batched prover on one rank of a mesh: voter lanes over 'data',
    proving-key tables, R1CS rows and the NTT domain over 'model'."""

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
        # and each shard's MSM chunk plan (as DeviceProver._msm_plans)
        self.tabs, self.padded, self._msm_plans = {}, {}, {}
        for key, (pts, kind) in points.items():
            tab = t(_table_shard(pts, nm, mi, kind))
            self.tabs[key] = tab
            self.padded[key] = tab.shape[0] * nm
            plan = msm_lm._chunks(tab.shape[0])
            chunks = [msm_lm.pad_chunk(None, tab, s, r, m, kind)[1]
                      for (s, r, m) in plan]
            self._msm_plans[key] = (plan, chunks, kind)
        self.alpha = t(ec_lm.g1_table([pk.alpha_g1]).T)
        self.beta1 = t(ec_lm.g1_table([pk.beta_g1]).T)
        self.beta2 = t(ec_lm.g2_table([pk.beta_g2]).T)

    # -- stages ---------------------------------------------------------------
    def _msm(self, scalars_full: torch.Tensor, key: str) -> torch.Tensor:
        """The MSM of this rank's shard of table `key` over its slice of
        the scalars, gathered over 'model' and reduced."""
        plan, chunks, kind = self._msm_plans[key]
        s = self.tabs[key].shape[0]
        i = self.mesh.model.index
        sc = scalars_full[i * s:(i + 1) * s]
        ws = [msm_lm.chunk_window_sums(
            msm_lm.pad_chunk(sc, None, st, r, m, kind)[0], tab, kind)
            for (st, r, m), tab in zip(plan, chunks)]
        partial = msm_lm.combine_horner(ws, kind, sc.shape[-1])
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
        w, w_plain = witness_stage(self.circuit, inputs)
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
        return pi_a, pi_b, pi_c, w_plain[1:1 + npub]

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
        r_arr, s_arr = draw_rs(seed, count)
        mesh = self.mesh
        local = {k: local_shard(v, mesh, _in_spec(k))
                 for k, v in inputs.items()}
        r_l, s_l = (local_shard(x, mesh, (None, "data"))
                    for x in (r_arr, s_arr))
        return self.finalize(*self.prove_fused(local, r_l, s_l))

    # planes -> snarkjs-format proofs, as the single-device prover does
    finalize = DeviceProver.finalize


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
