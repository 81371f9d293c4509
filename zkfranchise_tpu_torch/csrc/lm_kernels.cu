// Hand-written Hopper (sm_90a) kernels for the limb-major BN254 core.
//
// Layout (the JAX package's): a field element is 21 int32 limbs of 13
// bits, Montgomery R = 2^273, stored limb-major: limb i of element t sits
// at row i, lane t of a (..., 21, T) plane.  Points are planes of stacked
// coordinates: G1 projective 63 rows (X, Y, Z), G2 projective 126 rows
// (each Fq2 coordinate re then im), G1 affine 43 rows (x, y, inf mask),
// G2 affine 85 rows.
//
// Kernels and the TPU kernels they replace
// (zkfranchise_tpu/ops/pallas/lm_kernels.py):
//   zk_mont_mul          <- mont_mul      (_mont_mul_kernel): a*b*R^-1 mod p
//                           (the NTT's butterfly level: lm_ntt.cu)
//   zk_padd              <- padd          (_padd_kernel): p + q, RCB15
//   zk_fold_padd_levels  <- fold_padd     (_padd_kernel): x[j] + x[j + m/2],
//                                          n levels of the tree a launch
//   zk_fold_padd_aa      <- fold_padd_aa  (_padd_aa_kernel): affine pair ->
//                                          projective sum, Z1 = Z2 = 1
//   zk_scalar_mul        <- device_scalar_mul (scripts/verify_lm_device.py
//                           scalar_mul_kernel): k*P by double-and-add, a
//                           scalar per lane or one for all; on the main
//                           path the assembly's two G1 ladders
//   zk_fold2d            <- fold2d (scripts/layout_expt.py): one fold level
//                           on a FLAT lane axis (rows, B*m), per segment b
//                           lane b*m + j plus lane b*m + m/2 + j
//
// Design of mont_mul: one thread per element carries the product in
// registers and repeats the plain PyTorch version's steps in the same
// order (ops/lm.py mont_reduce with its carry trick), with the Karatsuba
// column sums of lm_device.cuh (915 multiply-adds instead of the
// schoolbook's 1,113; the same columns, so every output limb equals the
// plain version's).  Lanes sit on neighbouring threads, so every limb-row
// load and store is coalesced and a broadcast column is one load a warp;
// the leading dims go on the grid, so no thread divides 64-bit indices
// (they cost 26-41% of the time before); p and n' are launch parameters.
// What bounds it on an H100: integer issue.  At
// (8192, 21, 128) x (8192, 21, 1) it moves 176 MB (0.053 ms at 3.35
// TB/s) and issues about 1,800 instructions a product, 940 of them on the
// multiply-add pipe (0.057-0.06 ms at the card's highest clock); at 128
// registers four blocks fit an SM (at 168, three fit, and it read slower).
//
// Design of the EC kernels: the cooperative add.  A block takes 32 adds,
// one per lane, and each add a team of warps (padd, fold_padd and fold2d
// G1 3, G2 6; fold_padd_aa G1 4, G2 6); the products of RCB15 are dealt
// out, round by round, to the team's warps, whose lanes all play the same
// role for their own adds, and the operands, every intermediate field
// element and the result stay in the add's region of shared memory
// between the rounds (__syncthreads() between them).  Every product runs
// through one out-of-line routine (prod) whose operands and result are in
// shared memory, so nothing passes through local memory.
// The column sums are exact integers and the same weak_norm / mont_reduce
// steps run in the same order, so the limbs equal the plain versions'.
// One template (add_kernel) stages, runs a form's rounds and stores for
// padd and fold_padd_aa; the forms (PaddG1, PaddG2, PaddAaG1, PaddAaG2)
// give the team, the region and the rounds.
//   padd: points staged coalesced in both layouts the path gives it, T ==
//     1 planes (one point per batch row) and lane planes.
//   fold_padd_aa: the mixed add (Z1 = Z2 = 1) needs 4 products (G1) or 4
//     lazy Fq2 products (G2) before round 3, all independent of each other
//     (y3 = x1 + x2 needs none), so it has two product rounds instead of
//     three; the mask-row selection of ec_lm.padd_aa is applied as the
//     result is stored.
//   fold_padd (fold_levels_kernel): n levels of the sum tree in one launch
//     (n = 1 to 3, ops/cuda/lm_kernels.py fold_plan).  A block owns a
//     closed subtree (32 lanes of the last level) and adds it level by
//     level, staging each level's operands back from the lanes it stored
//     (L2), so it needs no more shared memory than one level and keeps as
//     many blocks resident; every level is written out once (the MSM reads
//     them all).  What it saves is launches: host time.
//   fold2d (flat_fold_kernel): the fold's add on the layout experiment's
//     flat lane axis; a block owns `tile` output lanes of one segment and
//     walks them 32 adds at a time, so a tile above 32 measures a block
//     that stays resident over several groups against one group a block.
//   scalar_mul (ladder_kernel): all the bits of the ladder in one launch,
//     two teams a block, one adding and one doubling, side by side; the
//     operands stay in shared memory between bits, acc in L1/L2.  A chain
//     of 2 x 254 dependent adds on 4 blocks at 128 lanes: bound by the
//     latency of one cooperative add a bit, not by the card's rate.
// What bounds them: integer multiply-adds (64 a clock per SM on Hopper,
// half the float32 rate).  With Karatsuba column products a Montgomery
// product is 342 + 231 + 342 = 915 multiply-adds on 168-252 bytes of
// traffic, a G1 add 11,091 on 756 bytes, a G2 add 31,758 on 1,512 bytes,
// the affine level-0 adds 7,431 and 21,702: compute-bound by a wide margin.
// They reach about 40% of the integer rate.  Not the multiply-add pipe:
// 18% fewer multiply-adds (Karatsuba against the schoolbook) gave 4-7%.
// Not residency: the schoolbook G1 fold at 128 registers kept five blocks
// an SM and was slower than Karatsuba's four (153 registers).  What
// remains is latency inside a team: three or four warps a scheduler, each
// a chain of dependent product phases between barriers, with a role idle
// in round 2 (PERF.md).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// out (N, 21, T) contiguous, N = d0*d1*d2; a and b are read through
// arbitrary element strides (a lane stride of 0 reads a broadcast column,
// a leading stride of 0 a shared table).  A block is blockDim.x lanes by
// blockDim.y rows of the last leading dim (lane_block); grid x covers the
// lanes, y the rows of d2 and z the d0*d1 pairs, each with a loop where
// it exceeds the grid.  Nothing is divided per thread but the one 32-bit
// split of a block's d0*d1 index.  At most 128 registers a thread, so
// that four blocks fit an SM.  p and n' arrive by value (FieldPN, in the
// constant bank of the launch's parameters).
__global__ void __launch_bounds__(THREADS, 4)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                int* __restrict__ out, const FieldPN pn, unsigned d01,
                unsigned d1, i64 d2, i64 T, i64 sa0, i64 sa1, i64 sa2,
                i64 sal, i64 sat, i64 sb0, i64 sb1, i64 sb2, i64 sbl,
                i64 sbt) {
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  for (unsigned n01 = blockIdx.z; n01 < d01; n01 += gridDim.z) {
    const unsigned i0 = n01 / d1, i1 = n01 - i0 * d1;
    const int* pa0 = a + i0 * sa0 + i1 * sa1 + t * sat;
    const int* pb0 = b + i0 * sb0 + i1 * sb1 + t * sbt;
    int* po0 = out + (i64)n01 * d2 * NL * T + t;
    for (i64 i2 = (i64)blockIdx.y * blockDim.y + threadIdx.y; i2 < d2;
         i2 += (i64)gridDim.y * blockDim.y) {
      const int* pa = pa0 + i2 * sa2;
      const int* pb = pb0 + i2 * sb2;
      int x[NL], y[NL], z[NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        x[k] = pa[k * sal];
        y[k] = pb[k * sbl];
      }
      mont_mul_karatsuba(x, y, pn.c, z);
      int* po = po0 + i2 * NL * T;
#pragma unroll
      for (int k = 0; k < NL; ++k) po[k * T] = z[k];
    }
  }
}

// ---------------------------------------------------------------------------
// padd: the cooperative RCB15 add
// ---------------------------------------------------------------------------
// A block owns ADDS = 32 adds, one per lane, and gives each add a team of
// warps: warp w's lanes all play role w, each for its own add, so every
// branch below is uniform across a warp.  An add's operands, its
// intermediate field elements and its result live in its own region of
// shared memory (STRIDE ints, odd, so the 32 lanes of a warp reading limb k
// of the same element hit 32 different banks), the constants the adds share
// after the last region; __syncthreads() separates the product rounds.
// G1: 3 warps, G2: 6 (layouts at PaddG1 and PaddG2).  Every product of a
// group runs through ONE out-of-line copy of the column products and the
// reduction (prod<GRP>), whose operands and result stay in shared memory,
// so each kernel holds one copy of that code instead of one per product.

#define ADDS 32
#define G1_WARPS 3
#define G2_WARPS 6
#define G1_STRIDE 317
#define G2_STRIDE 883

// The Fq constants of the EC block (ops/ec_lm.pack_ec_consts, rows p, n',
// sub_d, sub_d2, one, b3_g1, b3_g2), in constant memory so that every
// product with them takes its operand straight from the constant bank.  A
// CPU test (tests/test_torch_padd.py) holds each array against the packed
// block.
__constant__ int FQ_P[NL] = {7495, 999, 1462, 280, 5058, 1350, 455, 4653,
                             362, 3260, 5655, 770, 7016, 2082, 1761, 5125,
                             305, 5015, 6419, 96, 0};
__constant__ int FQ_NP[NL] = {905, 1075, 185, 1039, 6269, 5476, 6953, 3235,
                              7805, 1270, 5792, 4199, 7425, 6117, 3938, 4493,
                              4488, 5564, 7816, 8170, 4806};
__constant__ int FQ_SUBD[NL] = {8717, 10998, 16082, 11272, 14677, 14855,
                                13197, 10222, 12179, 11283, 13056, 8476,
                                11640, 14718, 11180, 15416, 11552, 14204,
                                13270, 1063, 0};
__constant__ int FQ_SUBD2[NL] = {10989, 10227, 13718, 12046, 12694, 8923,
                                 11379, 11664, 15589, 9108, 13805, 8562,
                                 14971, 15833, 10196, 15583, 13140, 10845,
                                 13898, 4160, 0};
__constant__ int FQ_ONE[NL] = {5790, 7107, 4720, 322, 1473, 4816, 6414, 4235,
                              3262, 2007, 7516, 7941, 3454, 1377, 2696, 6885,
                              1087, 4401, 337, 53, 0};
__constant__ int EC_B3G1[NL] = {5746, 2625, 3871, 1782, 1217, 5175, 6758,
                                3125, 3336, 5026, 4064, 2858, 3030, 4065, 836,
                                507, 376, 3166, 1935, 90, 0};
__constant__ int EC_B3G2[2 * NL] = {
    2261, 1884, 3964, 722, 5722, 5894, 1285, 5792, 6395, 2867, 4594,
    1787, 1916, 1848, 3760, 7948, 3267, 6331, 2836, 19, 0,
    6411, 6140, 7230, 4719, 1129, 6917, 4812, 8043, 5072, 4399, 4516,
    5037, 6023, 4376, 237, 5493, 4459, 4664, 7211, 83, 0};

// the padd kernels' dynamic shared memory
extern __shared__ int psm[];

// Products of the cooperative adds: the Karatsuba column sums of
// lm_device.cuh (cols_add).  On the card they made both groups' folds
// 4-7% faster than the schoolbook (PERF.md).

struct FromP {
  __device__ __forceinline__ unsigned operator()(int j) const {
    return (unsigned)FQ_P[j];
  }
};

// mont_reduce (lm_device.cuh) with p and n' from constant memory, and m*p
// added into t column by column: the same integers, so the same limbs
__device__ __forceinline__ void mont_reduce_fq(int* t, int* out) {
  weak_norm<WIDE>(t);
  weak_norm<WIDE>(t);
  int m[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL - i; ++j) m[i + j] += t[i] * FQ_NP[j];
  }
  weak_norm<NL>(m);
  weak_norm<NL>(m);
  cols_add(m, FromP(), t);
  reduce_tail(t, out);
}

template <int N>
__device__ __forceinline__ void load_n(const int* s, int* x) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = s[k];
}

template <int N>
__device__ __forceinline__ void store_n(int* s, const int* x) {
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = x[k];
}

// psm[o, o+21) = mont_reduce of the sum over i < n of the column sums of
// psm[a_i, +21) * psm[b_i, +21), each put through two weak_norm rounds
// first when `lazy` (the lazy terms of an Fq2 product or of round 3); n = 1
// without `lazy` is a Montgomery product.
template <int GRP>
__device__ __noinline__ void prod(int n, bool lazy, int a0, int b0, int a1,
                                  int b1, int a2, int b2, int a3, int b3,
                                  int o) {
  int acc[WIDE];
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int a = i == 0 ? a0 : (i == 1 ? a1 : (i == 2 ? a2 : a3));
    const int b = i == 0 ? b0 : (i == 1 ? b1 : (i == 2 ? b2 : b3));
    int x[NL], y[NL], c[WIDE];
    load_n<NL>(psm + a, x);
    load_n<NL>(psm + b, y);
#pragma unroll
    for (int k = 0; k < WIDE; ++k) c[k] = 0;
    cols_add(x, FromPtr{y}, c);
    if (lazy) {
      weak_norm<WIDE>(c);
      weak_norm<WIDE>(c);
    }
#pragma unroll
    for (int k = 0; k < WIDE; ++k) acc[k] += c[k];
  }
  int r[NL];
  mont_reduce_fq(acc, r);
  store_n<NL>(psm + o, r);
}

template <int GRP>
__device__ __forceinline__ void mul1(int a, int b, int o) {
  prod<GRP>(1, false, a, b, 0, 0, 0, 0, 0, 0, o);
}

template <int GRP>
__device__ __forceinline__ void lazy2(int a0, int b0, int a1, int b1,
                                      int o) {
  prod<GRP>(2, true, a0, b0, a1, b1, 0, 0, 0, 0, o);
}

// o = weak_norm(a + b) over W limbs (add_n)
template <int W>
__device__ __forceinline__ void s_add(const int* a, const int* b, int* o) {
  int x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = a[k] + b[k];
  weak_norm<W>(x);
  store_n<W>(o, x);
}

// o = weak_norm(a + (D - b)), D = sub_d per component (sub_n)
template <int W>
__device__ __forceinline__ void s_sub(const int* a, const int* b, int* o) {
  int x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = a[k] + (FQ_SUBD[k % NL] - b[k]);
  weak_norm<W>(x);
  store_n<W>(o, x);
}

// o = sub_n(s, add_n(t, u)) over W limbs: t3, t4, y3 of round 1
template <int W>
__device__ __forceinline__ void s_cross(const int* s, const int* t,
                                        const int* u, int* o) {
  int x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = t[k] + u[k];
  weak_norm<W>(x);
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = s[k] + (FQ_SUBD[k % NL] - x[k]);
  weak_norm<W>(x);
  store_n<W>(o, x);
}

// o = weak_norm(3 t) over W limbs: x3
template <int W>
__device__ __forceinline__ void s_triple(const int* t, int* o) {
  int x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = t[k] + t[k] + t[k];
  weak_norm<W>(x);
  store_n<W>(o, x);
}

// o = weak_norm(D2 - v) over one Fq component (neg_d2)
__device__ __forceinline__ void s_neg(const int* v, int* o) {
  int x[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) x[k] = FQ_SUBD2[k] - v[k];
  weak_norm<NL>(x);
  store_n<NL>(o, x);
}

// Per-add global offsets of the block's adds: add a of the block is
// n = blockIdx.x * ADDS + a of the `total` adds, b = n / T, t = n % T;
// p and q are its operands' offsets (one array when they are the same,
// TWO false), b and t kept for the outputs.
template <bool TWO>
struct Offsets {
  i64 p[ADDS], q[TWO ? ADDS : 1];
  int b[ADDS], t[ADDS];
  __device__ __forceinline__ i64 qo(int a) const {
    return TWO ? q[a] : p[a];
  }
};

template <bool TWO>
__device__ __forceinline__ void add_offsets(Offsets<TWO>& ofs, i64 total,
                                            i64 T, i64 pbs, i64 pts,
                                            i64 qbs, i64 qts) {
  if (threadIdx.x < ADDS) {
    const i64 n = (i64)blockIdx.x * ADDS + threadIdx.x;
    const i64 b = n < total ? n / T : 0, t = n < total ? n - b * T : 0;
    ofs.p[threadIdx.x] = b * pbs + t * pts;
    if (TWO) ofs.q[threadIdx.x] = b * qbs + t * qts;
    ofs.b[threadIdx.x] = (int)b;
    ofs.t[threadIdx.x] = (int)t;
  }
}

// Element u of this thread's share of a block's (ADDS, ROWS) points ->
// (add a, row r).  With one lane per batch row (T == 1, BY_ROWS) the
// points lie row after row, so consecutive threads take consecutive rows
// of one add; otherwise consecutive threads take the same row of
// consecutive adds (consecutive lanes).  Either way the device-memory side
// is coalesced and the shared side is free of bank conflicts.
template <int ROWS, int NT, bool BY_ROWS>
__device__ __forceinline__ void point_elem(int f, int& a, int& r) {
  if (BY_ROWS) {
    a = f / ROWS;
    r = f - a * ROWS;
  } else {
    r = f / ADDS;
    a = f % ADDS;
  }
}

// Stage the block's p and q points into the regions at `at` and
// at + ROWS: each of the NT threads has all its (at most PER) loads of
// each operand in flight before it stores any
template <int ROWS, int STRIDE, int NT, bool BY_ROWS, class O>
__device__ __forceinline__ void stage_in(int at, const int* p, const int* q,
                                         const O& ofs, i64 prs,
                                         i64 qrs, int nvalid) {
  constexpr int PER = (ADDS * ROWS + NT - 1) / NT;
  int vp[PER], vq[PER];
  const int t0 = tid();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(t0 + u * NT, a, r);
    const bool ok = a < nvalid && t0 + u * NT < ADDS * ROWS;
    vp[u] = ok ? p[ofs.p[a] + r * prs] : 0;
    vq[u] = ok ? q[ofs.qo(a) + r * qrs] : 0;
  }
  const int t1 = tid();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (t1 + u * NT >= ADDS * ROWS) break;
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(t1 + u * NT, a, r);
    psm[at + a * STRIDE + r] = vp[u];
    psm[at + a * STRIDE + ROWS + r] = vq[u];
  }
}

// Store the block's results to out[b * bs + t + r * rs] (add a's b and t
// from ofs); F::out(a, r) reads row r of add a's result from shared memory
template <class F, int NT, bool BY_ROWS, class O>
__device__ __forceinline__ void store_out(int* out, const O& ofs,
                                          i64 bs, i64 rs, int nvalid) {
  constexpr int ROWS = F::ROWS, PER = (ADDS * ROWS + NT - 1) / NT;
  const int t0 = tid();
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (t0 + u * NT >= ADDS * ROWS) break;
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(t0 + u * NT, a, r);
    if (a < nvalid)
      out[(i64)ofs.b[a] * bs + ofs.t[a] + r * rs] = F::out(a, r);
  }
}

// ---------------------------------------------------------------------------
// the four forms of the cooperative add: one struct each, giving its
// team, its region (operands at IN_AT, the result at OUT_AT), the
// constants it stages, its product rounds, and how a result row is read
// ---------------------------------------------------------------------------

// G1 projective: out (B, 63, T) = p + q.  Region of an add (ints), warp
// j (= role) of its team of three:
//   0 P, 63 Q                      staged operands
//   126 + 21j  T_j = X1X2, Y1Y2, Z1Z2;  189 + 21j  S_j = (X1+Y1)(X2+Y2),
//              (Y1+Z1)(Y2+Z2), (Z1+X1)(Z2+X2)   (round 1: warp j; S_j's
//              operand sums are first put in the two slots it fills)
//   after round 1: 21j t3, t4, y3 (warp j); 63 x3 (warp 0); 252 t2b =
//   t2*b3, 84 z3, 105 t1' (warp 1); 273 y3b = y3*b3, 294 -y3b (warp 2)
//   126 + 21j  output coordinate j (round 3: warp j, two lazy terms)
// Constants after the regions: b3.  Per thread: at most 3 products and 2
// lazy terms, 4,002 of the add's 11,091 multiply-adds.
struct PaddG1 {
  static constexpr int ROWS_IN = 63, ROWS = 63, WARPS = G1_WARPS;
  static constexpr int STRIDE = G1_STRIDE, IN_AT = 0, OUT_AT = 126;
  static constexpr int NCONST = NL, MAX_LEVELS = 3;
  static constexpr int GRP = 1;

  static __device__ __forceinline__ void consts(int KC) {
    if (threadIdx.x < NL) psm[KC + threadIdx.x] = EC_B3G1[threadIdx.x];
  }

  static __device__ __forceinline__ void rounds(int KC, int at, int j) {
    const int j1 = j == 2 ? 0 : j + 1;
    const int base = at + (threadIdx.x & 31) * STRIDE;
    int* s = psm + base;
    // round 1
    s_add<NL>(s + NL * j, s + NL * j1, s + 126 + NL * j);
    s_add<NL>(s + 63 + NL * j, s + 63 + NL * j1, s + 189 + NL * j);
    mul1<GRP>(base + 126 + NL * j, base + 189 + NL * j,
                    base + 189 + NL * j);
    mul1<GRP>(base + NL * j, base + 63 + NL * j, base + 126 + NL * j);
    __syncthreads();
    // t3, t4, y3; x3; round 2: t2b = t2*b3 and y3b = y3*b3
    s_cross<NL>(s + 189 + NL * j, s + 126 + NL * j, s + 126 + NL * j1,
                s + NL * j);
    if (j == 0) {
      s_triple<NL>(s + 126, s + 63);
    } else if (j == 1) {
      mul1<GRP>(base + 168, KC, base + 252);
      s_add<NL>(s + 147, s + 252, s + 84);
      s_sub<NL>(s + 147, s + 252, s + 105);
    } else {
      mul1<GRP>(base + 2 * NL, KC, base + 273);
      s_neg(s + 273, s + 294);
    }
    __syncthreads();
    // round 3: X = t3*t1' + t4*(-y3b), Y = y3b*x3 + t1'*z3, Z = z3*t4 +
    // x3*t3
    if (j == 0)
      lazy2<GRP>(base, base + 105, base + 21, base + 294, base + 126);
    else if (j == 1)
      lazy2<GRP>(base + 273, base + 63, base + 105, base + 84,
                       base + 147);
    else
      lazy2<GRP>(base + 84, base + 21, base + 63, base, base + 168);
    __syncthreads();
  }

  static __device__ __forceinline__ int out(int a, int r) {
    return psm[a * STRIDE + OUT_AT + r];
  }
};

// Round 3 over Fq2 (_round3_fq2): output component w = 2*o + c (o = X, Y,
// Z; c = re, im) is the reduction of four lazy terms; the pairs are region
// offsets (see PaddG2; PaddAaG2 keeps the same offsets), negations already
// taken.
__constant__ short G2_ROUND3[G2_WARPS][8] = {
    {0, 357, 21, 420, 42, 441, 63, 294},      // X re
    {0, 378, 21, 357, 42, 462, 63, 441},      // X im
    {273, 126, 294, 210, 357, 315, 378, 399}, // Y re
    {273, 147, 294, 126, 357, 336, 378, 315}, // Y im
    {315, 42, 336, 189, 126, 0, 147, 168},    // Z re
    {315, 63, 336, 42, 126, 21, 147, 0}};     // Z im

// b3 (re, im) and -im(b3) after the regions (both G2 forms)
__device__ __forceinline__ void g2_consts(int KC) {
  if (threadIdx.x < 2 * NL) psm[KC + threadIdx.x] = EC_B3G2[threadIdx.x];
  if (threadIdx.x == 2 * NL) {
    int x[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) x[k] = FQ_SUBD2[k] - EC_B3G2[NL + k];
    weak_norm<NL>(x);
    store_n<NL>(psm + KC + 2 * NL, x);
  }
}

// round 3 over Fq2 (every G2 form): warp w of the team reduces output
// component w into out + 21w
__device__ __forceinline__ void g2_round3(int base, int out, int w) {
  prod<2>(4, true, base + G2_ROUND3[w][0], base + G2_ROUND3[w][1],
       base + G2_ROUND3[w][2], base + G2_ROUND3[w][3],
       base + G2_ROUND3[w][4], base + G2_ROUND3[w][5],
       base + G2_ROUND3[w][6], base + G2_ROUND3[w][7], out + NL * w);
}

// G2 projective: out (B, 126, T) = p + q.  Fq2 values are 42 ints (re,
// im).  Region of an add (ints), warp w of its team of six:
//   0 P, 126 Q                     staged operands
//   252 + 42c  a'_c = P_c + P_c+1, 378 + 42c  b'_c = Q_c + Q_c+1,
//   504 + 21c  -im(Q_c), 567 + 21c  -im(b'_c)     (warps c and 3 + c)
//   630 + 21w  T component w, 756 + 21w  S component w   (round 1: warp
//              w = 2c + comp, comp of T_c = P_c Q_c and S_c = a'_c b'_c)
//   after round 1: 0, 42, 84 t3, t4, y3; 126 x3; 168 -im(t3); 189
//   -im(t4); 210 -im(x3); 231 t2b; 273 y3b (round 2: warps 0-3); 315 z3;
//   357 t1'; 399 -im(z3); 420 -im(t1'); 441 -re(y3b); 462 -im(y3b)
//   630 + 21w  output component w (round 3: four lazy terms)
// Constants after the regions: b3 (re, im), -im(b3).  Per thread: 4 + 2 +
// 4 lazy terms and 4 reductions, 5,712 of the add's 31,758 multiply-adds.
struct PaddG2 {
  static constexpr int ROWS_IN = 126, ROWS = 126, WARPS = G2_WARPS;
  static constexpr int STRIDE = G2_STRIDE, IN_AT = 0, OUT_AT = 630;
  static constexpr int NCONST = 3 * NL, MAX_LEVELS = 1;
  static constexpr int GRP = 2;

  static __device__ __forceinline__ void consts(int KC) { g2_consts(KC); }

  static __device__ __forceinline__ void rounds(int KC, int at, int w) {
    const int base = at + (threadIdx.x & 31) * STRIDE;
    int* s = psm + base;
    {  // the round-1 operands: sums and negated imaginary parts
      const int c = w < 3 ? w : w - 3, c1 = c == 2 ? 0 : c + 1;
      const int src = w < 3 ? 0 : 126, dst = w < 3 ? 252 : 378;
      s_add<2 * NL>(s + src + 42 * c, s + src + 42 * c1, s + dst + 42 * c);
      if (w < 3)
        s_neg(s + 126 + 42 * c + NL, s + 504 + NL * c);
      else
        s_neg(s + 378 + 42 * c + NL, s + 567 + NL * c);
    }
    __syncthreads();
    {  // round 1: re = a0 b0 + a1 (-b1), im = a0 b1 + a1 b0
      const int c = w >> 1, comp = w & 1;
      const int a = base + 42 * c, b = base + 126 + 42 * c;
      lazy2<GRP>(a, b + (comp ? NL : 0), a + NL,
                       comp ? b : base + 504 + NL * c, base + 630 + NL * w);
      const int sa = base + 252 + 42 * c, sb = base + 378 + 42 * c;
      lazy2<GRP>(sa, sb + (comp ? NL : 0), sa + NL,
                       comp ? sb : base + 567 + NL * c, base + 756 + NL * w);
    }
    __syncthreads();
    const int* T0 = s + 630;
    if (w < 3) {  // t3, t4, y3 = S_w - (T_w + T_w+1); -im(t3), -im(t4)
      const int w1 = w == 2 ? 0 : w + 1;
      s_cross<2 * NL>(T0 + 126 + 42 * w, T0 + 42 * w, T0 + 42 * w1,
                      s + 42 * w);
      if (w < 2) s_neg(s + 42 * w + NL, s + 168 + NL * w);
    } else if (w == 3) {  // x3 = 3 * T0, -im(x3)
      s_triple<2 * NL>(T0, s + 126);
      s_neg(s + 126 + NL, s + 210);
    }
    __syncthreads();
    if (w < 4) {  // round 2: component comp of t2b = t2*b3 or y3b = y3*b3
      const int comp = w & 1;
      const int a = w < 2 ? base + 630 + 84 : base + 84;
      lazy2<GRP>(a, KC + (comp ? NL : 0), a + NL,
                       comp ? KC : KC + 2 * NL,
                       base + (w < 2 ? 231 : 273) + NL * comp);
    }
    __syncthreads();
    if (w == 0) {  // z3 = t1 + t2b, t1' = t1 - t2b, and their -im
      s_add<2 * NL>(T0 + 42, s + 231, s + 315);
      s_neg(s + 315 + NL, s + 399);
    } else if (w == 1) {
      s_sub<2 * NL>(T0 + 42, s + 231, s + 357);
      s_neg(s + 357 + NL, s + 420);
    } else if (w < 4) {  // -re(y3b), -im(y3b)
      s_neg(s + 273 + NL * (w - 2), s + 441 + NL * (w - 2));
    }
    __syncthreads();
    g2_round3(base, base + OUT_AT, w);
    __syncthreads();
  }

  static __device__ __forceinline__ int out(int a, int r) {
    return psm[a * STRIDE + OUT_AT + r];
  }
};

// The mask-row selection of ec_lm.padd_aa, row r of add a's projective
// result, W = 21 (G1) or 42 (G2) ints a coordinate: an infinity flag on
// one side takes the other input (Z = one), on both the identity.  The
// affine operands sit at `in` (x, y, flag) and in + 2W + 1.
template <int W, int STRIDE, int IN, int OUT>
__device__ __forceinline__ int aa_select(int a, int r) {
  const int* s = psm + a * STRIDE;
  const bool inf1 = s[IN + 2 * W] == 1, inf2 = s[IN + 4 * W + 1] == 1;
  if (!inf1 && !inf2) return s[OUT + r];
  const int c = r / W, k = r - c * W;
  const int one = k < NL ? FQ_ONE[k] : 0;
  if (inf1 && inf2) return c == 1 ? one : 0;
  if (c == 2) return one;
  return s[IN + (inf1 ? 2 * W + 1 : 0) + r];
}

// G1, two AFFINE operands (Z1 = Z2 = 1: ec_lm._padd_aa), out (B, 63, T)
// projective.  Region of an add (ints), warp w of its team of four:
//   0 P (x1, y1, inf1), 43 Q (x2, y2, inf2)      staged operands
//   86 x1+y1, 107 x2+y2 (warp 2), 128 y3 = x1+x2 (warp 3)
//   round 1, one product a warp: 149 t0 = x1x2, 170 t1 = y1y2, 191 pa =
//   (x1+y1)(x2+y2), 212 y3b = y3*b3 (y3 needs no product, so its b3
//   scaling joins round 1 and the add has two rounds of products)
//   then: 233 t3 = pa - (t0+t1) (warp 0); 254 x3, 275 t4 = y1+y2 (warp 1);
//   296 z3 = t1+b3, 317 t1' = t1-b3 (warp 2); 338 -y3b (warp 3)
//   86 + 21j  output coordinate j (round 3: warp j < 3, two lazy terms)
// Constants after the regions: b3.  Per thread: one product and two lazy
// terms at most, 2,172 of the add's 7,431 multiply-adds.
struct PaddAaG1 {
  static constexpr int ROWS_IN = 43, ROWS = 63, WARPS = 4;
  static constexpr int STRIDE = 359, IN_AT = 0, OUT_AT = 86;
  static constexpr int NCONST = NL;
  static constexpr int GRP = 1;

  static __device__ __forceinline__ void consts(int KC) {
    PaddG1::consts(KC);
  }

  static __device__ __forceinline__ void rounds(int KC, int at, int w) {
    const int base = at + (threadIdx.x & 31) * STRIDE;
    int* s = psm + base;
    if (w == 0) {
      mul1<GRP>(base, base + 43, base + 149);
    } else if (w == 1) {
      mul1<GRP>(base + 21, base + 64, base + 170);
    } else if (w == 2) {
      s_add<NL>(s, s + 21, s + 86);
      s_add<NL>(s + 43, s + 64, s + 107);
      mul1<GRP>(base + 86, base + 107, base + 191);
    } else {
      s_add<NL>(s, s + 43, s + 128);
      mul1<GRP>(base + 128, KC, base + 212);
    }
    __syncthreads();
    if (w == 0) {
      s_cross<NL>(s + 191, s + 149, s + 170, s + 233);
    } else if (w == 1) {
      s_triple<NL>(s + 149, s + 254);
      s_add<NL>(s + 21, s + 64, s + 275);
    } else if (w == 2) {
      s_add<NL>(s + 170, psm + KC, s + 296);
      s_sub<NL>(s + 170, psm + KC, s + 317);
    } else {
      s_neg(s + 212, s + 338);
    }
    __syncthreads();
    // X = t3*t1' + t4*(-y3b), Y = y3b*x3 + t1'*z3, Z = z3*t4 + x3*t3
    if (w == 0)
      lazy2<GRP>(base + 233, base + 317, base + 275, base + 338,
                       base + 86);
    else if (w == 1)
      lazy2<GRP>(base + 212, base + 254, base + 317, base + 296,
                       base + 107);
    else if (w == 2)
      lazy2<GRP>(base + 296, base + 275, base + 254, base + 233,
                       base + 128);
    __syncthreads();
  }

  static __device__ __forceinline__ int out(int a, int r) {
    return aa_select<NL, STRIDE, IN_AT, OUT_AT>(a, r);
  }
};

// G2, two AFFINE operands, out (B, 126, T) projective.  The intermediate
// offsets of round 3 are PaddG2's, so both read G2_ROUND3.  Region of an
// add (ints), warp w of its team of six:
//   483 P (x1, y1, inf1), 568 Q (x2, y2, inf2)   staged operands
//   0 x1+y1 (warp 0), 42 x2+y2 and 210 -im(x2+y2) (warp 1), 126 y3 =
//   x1+x2 (warp 2), 168 -im(x2) (warp 3), 189 -im(y2) (warp 4)
//   round 1, component comp of product c by warp 2c + comp: 231 t0 =
//   x1x2, 653 t1 = y1y2, 84 pa = (x1+y1)(x2+y2); then warps 0, 1: 273 y3b
//   = y3*b3 (no product needed for y3, so it joins round 1)
//   then: 0 t3, 168 -im(t3) (warp 0); 126 x3, 210 -im(x3) (warp 1); 42
//   t4 = y1+y2, 189 -im(t4) (warp 2); 315 z3 = t1+b3, 399 -im(z3) (warp
//   3); 357 t1' = t1-b3, 420 -im(t1') (warp 4); 441 -re(y3b), 462
//   -im(y3b) (warp 5)
//   653 + 21w  output component w (round 3: four lazy terms)
// Constants after the regions: b3 (re, im), -im(b3).  Per thread: 4 + 4
// lazy terms and 3 reductions at most, 4,455 of the add's 21,702
// multiply-adds.
struct PaddAaG2 {
  static constexpr int ROWS_IN = 85, ROWS = 126, WARPS = G2_WARPS;
  static constexpr int STRIDE = 779, IN_AT = 483, OUT_AT = 653;
  static constexpr int NCONST = 3 * NL;
  static constexpr int GRP = 2;

  static __device__ __forceinline__ void consts(int KC) { g2_consts(KC); }

  static __device__ __forceinline__ void rounds(int KC, int at, int w) {
    const int base = at + (threadIdx.x & 31) * STRIDE;
    int* s = psm + base;
    const int* P = s + IN_AT;
    const int* Q = s + IN_AT + 85;
    if (w == 0) {
      s_add<2 * NL>(P, P + 42, s);
    } else if (w == 1) {
      s_add<2 * NL>(Q, Q + 42, s + 42);
      s_neg(s + 42 + NL, s + 210);
    } else if (w == 2) {
      s_add<2 * NL>(P, Q, s + 126);
    } else if (w == 3) {
      s_neg(Q + NL, s + 168);
    } else if (w == 4) {
      s_neg(Q + 42 + NL, s + 189);
    }
    __syncthreads();
    {  // round 1: re = a0 b0 + a1 (-b1), im = a0 b1 + a1 b0
      const int c = w >> 1, comp = w & 1;
      const int a = c == 0 ? base + IN_AT : (c == 1 ? base + IN_AT + 42
                                                    : base);
      const int b = c == 0 ? base + IN_AT + 85
                           : (c == 1 ? base + IN_AT + 127 : base + 42);
      const int nb = base + 168 + NL * c;
      const int o = c == 0 ? 231 : (c == 1 ? 653 : 84);
      lazy2<GRP>(a, b + (comp ? NL : 0), a + NL, comp ? b : nb,
                       base + o + NL * comp);
      if (w < 2)
        lazy2<GRP>(base + 126, KC + (comp ? NL : 0), base + 126 + NL,
                         comp ? KC : KC + 2 * NL, base + 273 + NL * comp);
    }
    __syncthreads();
    if (w == 0) {
      s_cross<2 * NL>(s + 84, s + 231, s + 653, s);
      s_neg(s + NL, s + 168);
    } else if (w == 1) {
      s_triple<2 * NL>(s + 231, s + 126);
      s_neg(s + 126 + NL, s + 210);
    } else if (w == 2) {
      s_add<2 * NL>(P + 42, Q + 42, s + 42);
      s_neg(s + 42 + NL, s + 189);
    } else if (w == 3) {
      s_add<2 * NL>(s + 653, psm + KC, s + 315);
      s_neg(s + 315 + NL, s + 399);
    } else if (w == 4) {
      s_sub<2 * NL>(s + 653, psm + KC, s + 357);
      s_neg(s + 357 + NL, s + 420);
    } else {
      s_neg(s + 273, s + 441);
      s_neg(s + 273 + NL, s + 462);
    }
    __syncthreads();
    g2_round3(base, base + OUT_AT, w);
    __syncthreads();
  }

  static __device__ __forceinline__ int out(int a, int r) {
    return aa_select<2 * NL, STRIDE, IN_AT, OUT_AT>(a, r);
  }
};

template <class F>
constexpr int form_smem() {
  return (ADDS * F::STRIDE + F::NCONST) * 4;
}

// ---------------------------------------------------------------------------
// kernels on the forms
// ---------------------------------------------------------------------------

// out (B, ROWS, T) contiguous = p + q for B*T adds; p and q are read
// through batch, row and lane strides (a stride of 0 reads a broadcast
// operand in place).  padd (PaddG1, PaddG2) and the one-level fold of
// affine planes (PaddAaG1, PaddAaG2: p = x, q = x + h, T = h).
template <class F, bool BY_ROWS>
__global__ void __launch_bounds__(F::WARPS * 32)
add_kernel(const int* __restrict__ p, const int* __restrict__ q,
           int* __restrict__ out, i64 total, i64 T, i64 pbs, i64 prs,
           i64 pts, i64 qbs, i64 qrs, i64 qts) {
  constexpr int NT = F::WARPS * 32;
  __shared__ Offsets<true> ofs;
  add_offsets(ofs, total, T, pbs, pts, qbs, qts);
  __syncthreads();
  const i64 first = (i64)blockIdx.x * ADDS;
  const int nvalid = (int)(total - first < ADDS ? total - first : ADDS);
  const int KC = ADDS * F::STRIDE;
  stage_in<F::ROWS_IN, F::STRIDE, NT, BY_ROWS>(F::IN_AT, p, q, ofs, prs,
                                               qrs, nvalid);
  F::consts(KC);
  __syncthreads();
  F::rounds(KC, 0, threadIdx.x >> 5);
  store_out<F, NT, BY_ROWS>(out, ofs, F::ROWS * T, T, nvalid);
}

// N levels of the projective sum tree in one launch (N = 1 to 3): x (B,
// ROWS, 2h) contiguous; level l (width h_l = h >> l) goes to out +
// B*ROWS*(h + ... + h_(l-1)) as (B, ROWS, h_l), lane j = x[j] + x[j + h_l]
// of level l - 1 (of x for l = 0).  The block owns 32 lanes t of the last
// level (width hl = h >> (N-1)), and at level l the lanes t + g*hl, g <
// 2^(N-1-l): a closed subtree, which it adds level by level.  A level's
// operands are the lanes this block stored one level down, so after a
// barrier the block stages them back from device memory (L2 holds them),
// and the kernel needs no shared memory beyond the one-level add's: as many
// blocks stay resident as for one level.  (Keeping each level in shared
// memory instead, one 8 KB slot a level, cost the schoolbook G1 kernel
// one of its five resident blocks an SM.)
template <class F, int N, int MIN_BLOCKS>
__global__ void __launch_bounds__(F::WARPS * 32, MIN_BLOCKS)
fold_levels_kernel(const int* __restrict__ x, int* out, i64 B, i64 h) {
  constexpr int NT = F::WARPS * 32, R = F::ROWS;
  __shared__ Offsets<false> ofs;
  const i64 hl = h >> (N - 1), total = B * hl;
  add_offsets(ofs, total, hl, R * 2 * h, 1, R * 2 * h, 1);
  const int KC = ADDS * F::STRIDE;
  F::consts(KC);
  __syncthreads();
  const i64 first = (i64)blockIdx.x * ADDS;
  const int nvalid = (int)(total - first < ADDS ? total - first : ADDS);
  i64 off = 0;                      // level l's offset in out
  // not unrolled: one copy of the rounds' code serves every level and
  // group (unrolled, with seven copies of it, a three-level launch ran
  // about 25% slower per add than three one-level launches)
#pragma unroll 1
  for (int l = 0; l < N; ++l) {
    const i64 hw = h >> l;          // level l's width; its input's is 2 hw
    const int* in = l == 0 ? x : out + off - B * R * 2 * hw;
    if (l > 0) {                    // level l - 1 stored: rebase the offsets
      __syncthreads();
      if (tid() < ADDS)
        ofs.p[tid()] = (i64)ofs.b[tid()] * R * 2 * hw + ofs.t[tid()];
      __syncthreads();
    }
#pragma unroll 1
    for (int g = 0; g < (1 << (N - 1 - l)); ++g) {
      stage_in<R, F::STRIDE, NT, false>(F::IN_AT, in + g * hl,
                                        in + hw + g * hl, ofs, 2 * hw,
                                        2 * hw, nvalid);
      __syncthreads();
      F::rounds(KC, 0, threadIdx.x >> 5);
      store_out<F, NT, false>(out + off + g * hl, ofs, R * hw, hw, nvalid);
    }
    off += B * R * hw;
  }
}

// One fold level on a FLAT lane axis (the layout experiment's fold2d): x
// (rows, B*2h) contiguous, segment b the lanes [b*2h, (b+1)*2h); out (rows,
// B*h) contiguous, out lane b*h + j = x lane b*2h + j plus x lane b*2h + h
// + j.  Block (i, b) owns output lanes [i*tile, (i+1)*tile) of segment b
// and walks them in groups of ADDS = 32 adds, the last group masked at the
// segment's or the tile's end: each group is one cooperative add of the
// form F, its operands read through the flat layout's strides (row stride
// B*2h, lane stride 1, q = p + h), its result stored through the output's
// (row stride B*h).  At tile 32 a block is one group, as in
// fold_levels_kernel; a larger tile keeps a block resident for
// ceil(tile / 32) groups (the constants are staged once).

// One group: output lanes [j0, j0 + nvalid) of segment blockIdx.y.  Out of
// line, so that what the rounds derive from a thread's role is computed
// for each group, as in a one-level fold, and not hoisted out of the
// block's loop and carried across every group's products (so the G2
// kernel spilled).
template <class F>
__device__ __noinline__ void flat_group(const int* x, int* out, i64 B, i64 h,
                                        i64 j0, int nvalid) {
  constexpr int NT = F::WARPS * 32;
  __shared__ Offsets<false> ofs;
  __syncthreads();                  // the previous group is stored
  if (tid() < ADDS) {
    ofs.p[tid()] = (i64)ctaid_y() * 2 * h + j0 + tid();
    ofs.b[tid()] = ctaid_y();
    ofs.t[tid()] = (int)(j0 + tid());
  }
  __syncthreads();
  stage_in<F::ROWS_IN, F::STRIDE, NT, false>(F::IN_AT, x, x + h, ofs,
                                             B * 2 * h, B * 2 * h, nvalid);
  __syncthreads();
  F::rounds(ADDS * F::STRIDE, 0, threadIdx.x >> 5);
  store_out<F, NT, false>(out, ofs, h, B * h, nvalid);
}

template <class F, int MIN_BLOCKS>
__global__ void __launch_bounds__(F::WARPS * 32, MIN_BLOCKS)
flat_fold_kernel(const int* __restrict__ x, int* __restrict__ out, i64 B,
                 i64 h, i64 tile) {
  F::consts(ADDS * F::STRIDE);
  // only g lives across a group; the lanes are recomputed from the block
  // index
#pragma unroll 1
  for (int g = 0;; ++g) {
    const i64 lane0 = (i64)ctaid_x() * tile, j0 = lane0 + (i64)g * ADDS;
    const i64 end = h - lane0 < tile ? h : lane0 + tile;
    if (j0 >= end) break;
    flat_group<F>(x, out, B, h, j0, (int)(end - j0 < ADDS ? end - j0 : ADDS));
  }
}

// k * P for every lane, k given LSB first (tools and assembly: the ladder
// of groth16/device.py scalar_mul_plane): acc <- bit ? acc + base : acc,
// base <- base + base, acc starting at the identity (0 : 1 : 0).  pts and
// out (ROWS, T) contiguous; bit i of lane t at bits[i * sbi + t * sbt] (sbt
// = 0: one scalar for all lanes).  A block takes 32 lanes and has two
// teams of F::WARPS warps: team 0 adds acc + base in the first region,
// team 1 doubles base in the second, side by side (the two adds of a bit
// are independent) with the same rounds, so with the same barriers.  After
// a bit the doubled base is copied in shared memory into the operand slots
// of both regions.  acc lives in `out` (L1, L2): it is staged in before
// each bit and written back by the threads whose lane's bit is 1, a store
// under a per-thread predicate, so no warp branches apart.  (The rounds
// reuse every int of a region, and two G2 regions leave no room for a
// third copy of acc in shared memory.)
template <class F>
__global__ void __launch_bounds__(2 * F::WARPS * 32)
ladder_kernel(const int* __restrict__ pts, int* out,
              const int* __restrict__ bits, i64 sbi, i64 sbt, int nbits,
              i64 T) {
  constexpr int NT = 2 * F::WARPS * 32, R = F::ROWS, S = F::STRIDE;
  constexpr int P = F::IN_AT, Q = F::IN_AT + R, O = F::OUT_AT;
  constexpr int RB = ADDS * S, KC = 2 * ADDS * S;
  const i64 t0 = (i64)blockIdx.x * ADDS;
  const int nvalid = (int)(T - t0 < ADDS ? T - t0 : ADDS);
  F::consts(KC);
  for (int f = tid(); f < ADDS * R; f += NT) {
    const int r = f / ADDS, a = f % ADDS;
    const int v = a < nvalid ? pts[r * T + t0 + a] : 0;
    psm[a * S + Q + r] = v;
    psm[RB + a * S + P + r] = v;
    psm[RB + a * S + Q + r] = v;
    // the identity: Y = one (over Fq2 (one, 0)), X = Z = 0
    if (a < nvalid)
      out[r * T + t0 + a] = r >= R / 3 && r < R / 3 + NL ? FQ_ONE[r - R / 3]
                                                         : 0;
  }
  const int team = threadIdx.x >= F::WARPS * 32;
  const int w = (threadIdx.x >> 5) - team * F::WARPS;
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    for (int f = tid(); f < ADDS * R; f += NT) {
      const int r = f / ADDS, a = f % ADDS;
      psm[a * S + P + r] = a < nvalid ? out[r * T + t0 + a] : 0;
    }
    __syncthreads();
    F::rounds(KC, team * RB, w);       // ends at a barrier
    for (int f = tid(); f < ADDS * R; f += NT) {
      const int r = f / ADDS, a = f % ADDS;
      if (a < nvalid && bits[i * sbi + (t0 + a) * sbt] == 1)
        out[r * T + t0 + a] = psm[a * S + O + r];
      const int v = psm[RB + a * S + O + r];
      psm[a * S + Q + r] = v;
      psm[RB + a * S + P + r] = v;
      psm[RB + a * S + Q + r] = v;
    }
    __syncthreads();
  }
}

template <class F>
static int launch_ladder(const int* pts, int* out, const int* bits, i64 sbi,
                         i64 sbt, int nbits, i64 T, cudaStream_t s) {
  auto kernel = ladder_kernel<F>;
  const int smem = (2 * ADDS * F::STRIDE + F::NCONST) * 4;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((T + ADDS - 1) / ADDS);
  kernel<<<blocks, 2 * F::WARPS * 32, smem, s>>>(pts, out, bits, sbi, sbt,
                                                 nbits, T);
  return (int)cudaGetLastError();
}

// launch add_kernel<F, T == 1> for B*T adds
template <class F>
static int launch_add(const int* p, const int* q, int* out, i64 total,
                      i64 T, i64 pbs, i64 prs, i64 pts, i64 qbs, i64 qrs,
                      i64 qts, cudaStream_t s) {
  auto kernel = T == 1 ? add_kernel<F, true> : add_kernel<F, false>;
  // shared memory above 48 KB must be asked for (per kernel and device)
  const int smem = form_smem<F>();
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((total + ADDS - 1) / ADDS);
  kernel<<<blocks, F::WARPS * 32, smem, s>>>(p, q, out, total, T, pbs, prs,
                                             pts, qbs, qrs, qts);
  return (int)cudaGetLastError();
}

// the fold kernels' resident blocks per SM, at least: G1 four (the
// registers of the Karatsuba product allow no more without spilling), G2
// two (as many as its region allows)
#define G1_FOLD_BLOCKS 4
#define G2_FOLD_BLOCKS 2

template <class F, int N, int MIN_BLOCKS>
static int launch_levels(const int* x, int* out, i64 B, i64 h,
                         cudaStream_t s) {
  auto kernel = fold_levels_kernel<F, N, MIN_BLOCKS>;
  const int smem = form_smem<F>();
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((B * (h >> (N - 1)) + ADDS - 1) / ADDS);
  kernel<<<blocks, F::WARPS * 32, smem, s>>>(x, out, B, h);
  return (int)cudaGetLastError();
}

// n from 1 to F::MAX_LEVELS (G1 3; G2 1: at its 168 registers a thread
// the G2 kernel for two or three levels spills)
template <class F, int MIN_BLOCKS>
static int launch_levels(const int* x, int* out, i64 B, i64 h, int n,
                         cudaStream_t s) {
  if (n == 1) return launch_levels<F, 1, MIN_BLOCKS>(x, out, B, h, s);
  if constexpr (F::MAX_LEVELS >= 3) {
    if (n == 2) return launch_levels<F, 2, MIN_BLOCKS>(x, out, B, h, s);
    if (n == 3) return launch_levels<F, 3, MIN_BLOCKS>(x, out, B, h, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <class F, int MIN_BLOCKS>
static int launch_flat_fold(const int* x, int* out, i64 B, i64 h, i64 tile,
                            cudaStream_t s) {
  auto kernel = flat_fold_kernel<F, MIN_BLOCKS>;
  const int smem = form_smem<F>();
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((h + tile - 1) / tile), (unsigned)B);
  kernel<<<grid, F::WARPS * 32, smem, s>>>(x, out, B, h, tile);
  return (int)cudaGetLastError();
}

template <class F>
static int occupancy(const void* kernel, int smem) {
  int blocks = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                       F::WARPS * 32, smem);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

// the same for the scalar_mul ladder: two teams a block, two regions of
// shared memory (launch_ladder's geometry)
template <class F>
static int ladder_occupancy() {
  const void* kernel = (const void*)ladder_kernel<F>;
  const int smem = (2 * ADDS * F::STRIDE + F::NCONST) * 4;
  int blocks = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, 2 * F::WARPS * 32, smem);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

extern "C" {

// pn: p and n' of the field (42 ints) in HOST memory; tx: lanes a block
// (a power of two <= THREADS, lane_block); d0 * d1 < 2^32 (the wrapper
// checks).  The grid holds at most about max_blocks
// blocks (two rounds of four resident blocks an SM): the rows beyond loop
// inside the blocks, which read faster than one block a row of 128 lanes
// at (8192, 21, 128) on an H100, and than one round of blocks.
int zk_mont_mul(const int* a, const int* b, int* out, const int* pn,
                i64 d0, i64 d1, i64 d2, i64 T, int tx, i64 max_blocks,
                i64 sa0, i64 sa1, i64 sa2, i64 sal, i64 sat, i64 sb0,
                i64 sb1, i64 sb2, i64 sbl, i64 sbt, void* stream) {
  const dim3 block(tx, THREADS / tx);
  const unsigned gx = lane_blocks(T, tx), gz = grid_cap(d0 * d1, 1);
  const i64 room = max_blocks / ((i64)gx * gz);
  const unsigned gy = grid_cap(d2, THREADS / tx);
  const dim3 grid(gx, room < gy ? (room > 1 ? (unsigned)room : 1u) : gy, gz);
  FieldPN f;
  for (int k = 0; k < 2 * NL; ++k) f.c[k] = pn[k];
  mont_mul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      a, b, out, f, (unsigned)(d0 * d1), (unsigned)d1, d2, T, sa0, sa1, sa2,
      sal, sat, sb0, sb1, sb2, sbl, sbt);
  return (int)cudaGetLastError();
}

int zk_padd(int k, const int* p, const int* q, int* out, i64 B, i64 T,
            i64 pbs, i64 prs, i64 pts, i64 qbs, i64 qrs, i64 qts,
            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return k == 1 ? launch_add<PaddG1>(p, q, out, B * T, T, pbs, prs, pts, qbs,
                                     qrs, qts, s)
                : launch_add<PaddG2>(p, q, out, B * T, T, pbs, prs, pts, qbs,
                                     qrs, qts, s);
}

// out: the n levels back to back (level l at B*rows*(h + ... + h_(l-1))),
// n from 1 to 3 (G1) or 1 (G2)
int zk_fold_padd_levels(int k, const int* x, int* out, i64 B, i64 h, int n,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return k == 1 ? launch_levels<PaddG1, G1_FOLD_BLOCKS>(x, out, B, h, n, s)
                : launch_levels<PaddG2, G2_FOLD_BLOCKS>(x, out, B, h, n, s);
}

// out (B, rows, h) projective from x (B, arows, 2h) affine
int zk_fold_padd_aa(int k, const int* x, int* out, i64 B, i64 h,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 ar = 2 * k * NL + 1;
  return k == 1 ? launch_add<PaddAaG1>(x, x + h, out, B * h, h, ar * 2 * h,
                                       2 * h, 1, ar * 2 * h, 2 * h, 1, s)
                : launch_add<PaddAaG2>(x, x + h, out, B * h, h, ar * 2 * h,
                                       2 * h, 1, ar * 2 * h, 2 * h, 1, s);
}

// out (rows, B*h) from x (rows, B*2h), both flat and contiguous; tile:
// output lanes a block (grid (ceil(h / tile), B))
int zk_fold2d(int k, const int* x, int* out, i64 B, i64 h, i64 tile,
              void* stream) {
  if (tile < 1 || B < 1 || B > 65535 || (h + tile - 1) / tile > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return k == 1
             ? launch_flat_fold<PaddG1, G1_FOLD_BLOCKS>(x, out, B, h, tile, s)
             : launch_flat_fold<PaddG2, G2_FOLD_BLOCKS>(x, out, B, h, tile, s);
}

// out (rows, T) = k * pts for every lane, bit i of lane t at bits[i * sbi
// + t * sbt]
int zk_scalar_mul(int k, const int* pts, int* out, const int* bits, i64 sbi,
                  i64 sbt, int nbits, i64 T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return k == 1 ? launch_ladder<PaddG1>(pts, out, bits, sbi, sbt, nbits, T, s)
                : launch_ladder<PaddG2>(pts, out, bits, sbi, sbt, nbits, T, s);
}

// resident blocks per SM of each cooperative kernel at its shared memory:
// padd G1, G2 (lane planes), fold_padd_aa G1, G2, fold_padd_levels G1 at
// `levels` levels (1 to 3), G2 at one -> blocks[0..5]; a negative entry is
// a CUDA error
int zk_occupancy(int levels, int* blocks) {
  const void* g1[3] = {
      (const void*)fold_levels_kernel<PaddG1, 1, G1_FOLD_BLOCKS>,
      (const void*)fold_levels_kernel<PaddG1, 2, G1_FOLD_BLOCKS>,
      (const void*)fold_levels_kernel<PaddG1, 3, G1_FOLD_BLOCKS>};
  if (levels < 1 || levels > 3) return (int)cudaErrorInvalidValue;
  blocks[0] = occupancy<PaddG1>((const void*)add_kernel<PaddG1, false>,
                                form_smem<PaddG1>());
  blocks[1] = occupancy<PaddG2>((const void*)add_kernel<PaddG2, false>,
                                form_smem<PaddG2>());
  blocks[2] = occupancy<PaddAaG1>((const void*)add_kernel<PaddAaG1, false>,
                                  form_smem<PaddAaG1>());
  blocks[3] = occupancy<PaddAaG2>((const void*)add_kernel<PaddAaG2, false>,
                                  form_smem<PaddAaG2>());
  blocks[4] = occupancy<PaddG1>(g1[levels - 1], form_smem<PaddG1>());
  blocks[5] = occupancy<PaddG2>(
      (const void*)fold_levels_kernel<PaddG2, 1, G2_FOLD_BLOCKS>,
      form_smem<PaddG2>());
  return 0;
}

// resident blocks per SM of the scalar_mul ladder, G1 and G2 -> blocks[0..1]
int zk_ladder_occupancy(int* blocks) {
  blocks[0] = ladder_occupancy<PaddG1>();
  blocks[1] = ladder_occupancy<PaddG2>();
  return 0;
}

}  // extern "C"
