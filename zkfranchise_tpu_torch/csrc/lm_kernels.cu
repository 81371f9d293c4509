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
//   zk_mont_mul      <- mont_mul      (_mont_mul_kernel): a*b*R^-1 mod p
//   zk_padd          <- padd          (_padd_kernel): p + q, RCB15
//   zk_fold_padd     <- fold_padd     (_padd_kernel): x[j] + x[j + m/2]
//   zk_fold_padd_aa  <- fold_padd_aa  (_padd_aa_kernel): affine pair ->
//                                      projective sum, Z1 = Z2 = 1
//
// Design of mont_mul, fold_padd and fold_padd_aa: one thread per lane
// (element or point) carries the 21-limb schoolbook in registers and
// repeats the plain PyTorch version's steps in the same order (ops/lm.py
// mont_reduce with its carry trick; ops/ec_lm RCB15 in three product rounds
// with the lazy Fq2 products and the lazy round 3), so every output limb
// equals the plain version's.  Neighbouring threads own neighbouring lanes,
// so every limb-row load and store is coalesced; the constants block is
// staged in shared memory per block.  fold_padd, fold_padd_aa, and in
// lm_chains.cu / lm_layout.cu scalar_mul and fold2d, still add with this
// one-thread padd_point (lm_device.cuh): its out-of-line helpers pass every
// limb array through local memory, and the G2 form spills.
//
// Design of padd: cooperative.  A block takes 32 adds, one per lane, and
// each add a team of warps (G1 3, G2 6); the round-1, round-2 and round-3
// products of RCB15 are dealt out to the team's warps, whose lanes all
// play the same role for their own adds, and the operands, every
// intermediate field element and the result stay in the add's region of
// shared memory between the rounds (__syncthreads() between them).  So a
// 128-add launch still spreads over 12 or 24 warps on 4 SMs, and a
// 16,384-add launch (the MSM's width-128 planes) puts 12 warps on every SM
// in one wave (G2: two waves of 12).  The
// points are staged with all of a thread's loads in flight: coalesced in
// both layouts the path gives it, T == 1 planes (one point per batch row,
// 63 or 126 consecutive ints) and lane planes.  Every product of both
// kernels runs through one out-of-line routine (prod) whose operands and
// result are in shared memory, so nothing passes through local memory and
// neither form spills.  Since the column sums are exact integers and the
// same weak_norm / mont_reduce steps run in the same order, the limbs equal
// padd_ref's.  What bounds it now: integer multiply-adds (64 a clock per
// SM on Hopper, half the float32 rate the bounds are stated in), reached
// only when enough warps are resident to hide the products' latencies; a
// width-128 launch fills the card in one wave, so the rounds' barriers and
// the staging are not hidden behind other blocks.
//
// What bounds all four on an H100: integer multiply-adds.  A Montgomery
// product is 441 + 231 + 441 = 1113 multiply-adds on 168-252 bytes of
// traffic, a G1 add 13,566 on 756 bytes, a G2 add 39,480 on 1,512 bytes:
// all are compute-bound by a wide margin, never memory-bound.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// out (N, 21, T) contiguous, N = d0*d1*d2; a and b are read through
// arbitrary element strides (a lane stride of 0 reads a broadcast column)
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                int* __restrict__ out, const int* __restrict__ consts,
                i64 d1, i64 d2, i64 T, i64 total, i64 sa0, i64 sa1, i64 sa2,
                i64 sal, i64 sat, i64 sb0, i64 sb1, i64 sb2, i64 sbl,
                i64 sbt) {
  __shared__ int C[2 * NL];
  stage_consts(consts, C, 2 * NL);
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const i64 t = idx % T;
  const i64 n = idx / T;
  const i64 i2 = n % d2;
  const i64 i1 = (n / d2) % d1;
  const i64 i0 = n / (d1 * d2);
  const int* pa = a + i0 * sa0 + i1 * sa1 + i2 * sa2 + t * sat;
  const int* pb = b + i0 * sb0 + i1 * sb1 + i2 * sb2 + t * sbt;
  int x[NL], y[NL], z[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    x[k] = pa[k * sal];
    y[k] = pb[k * sbl];
  }
  mont_mul(x, y, C, z);
  int* po = out + n * NL * T + t;
#pragma unroll
  for (int k = 0; k < NL; ++k) po[k * T] = z[k];
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
// G1: 3 warps, G2: 6 (layouts at padd_g1_kernel and padd_g2_kernel).  Every
// product of both kernels runs through ONE out-of-line copy of the
// schoolbook and the reduction (prod), whose operands and result stay in
// shared memory, so each kernel holds one copy of that code instead of one
// per product.

#define ADDS 32
#define G1_WARPS 3
#define G2_WARPS 6
#define G1_STRIDE 317
#define G2_STRIDE 883
#define G1_SMEM ((ADDS * G1_STRIDE + NL) * 4)
#define G2_SMEM ((ADDS * G2_STRIDE + 3 * NL) * 4)

// The Fq constants of the EC block (ops/ec_lm.pack_ec_consts, rows p, n',
// sub_d, sub_d2, b3_g1, b3_g2), in constant memory so that every product
// with them takes its operand straight from the constant bank.  A CPU test
// (tests/test_torch_padd.py) holds each array against the packed block.
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
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) t[i + j] += m[i] * FQ_P[j];
  }
  weak_norm<WIDE>(t);
  weak_norm<WIDE>(t);
  weak_norm<WIDE>(t);
  int nz = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) nz |= t[k];
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k] = t[NL + k];
  out[0] += (nz != 0);
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
    wide_mul(x, y, c);
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

__device__ __forceinline__ void mul1(int a, int b, int o) {
  prod(1, false, a, b, 0, 0, 0, 0, 0, 0, o);
}

__device__ __forceinline__ void lazy2(int a0, int b0, int a1, int b1,
                                      int o) {
  prod(2, true, a0, b0, a1, b1, 0, 0, 0, 0, o);
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
// n = blockIdx.x * ADDS + a of the B*T adds, b = n / T, t = n % T.
struct AddOffsets {
  i64 p[ADDS], q[ADDS], o[ADDS];
};

__device__ __forceinline__ void add_offsets(AddOffsets& ofs, i64 total,
                                            i64 T, i64 rows, i64 pbs,
                                            i64 pts, i64 qbs, i64 qts) {
  if (threadIdx.x < ADDS) {
    const i64 n = (i64)blockIdx.x * ADDS + threadIdx.x;
    const i64 b = n < total ? n / T : 0, t = n < total ? n - b * T : 0;
    ofs.p[threadIdx.x] = b * pbs + t * pts;
    ofs.q[threadIdx.x] = b * qbs + t * qts;
    ofs.o[threadIdx.x] = b * rows * T + t;
  }
}

// Element u of this thread's share of a block's (ADDS, ROWS) points ->
// (add a, row r).  With one lane per batch row (T == 1, BY_ROWS) the
// points lie row after row, so consecutive threads take consecutive rows
// of one add; otherwise consecutive threads take the same row of
// consecutive adds (consecutive lanes).  Either way the device-memory side
// is coalesced and the shared side is free of bank conflicts.
template <int ROWS, int NT, bool BY_ROWS>
__device__ __forceinline__ void point_elem(int u, int& a, int& r) {
  const int f = threadIdx.x + u * NT;
  if (BY_ROWS) {
    a = f / ROWS;
    r = f - a * ROWS;
  } else {
    r = f / ADDS;
    a = f % ADDS;
  }
}

// Stage the block's p and q points into the regions at 0 and ROWS: each
// of the NT threads has all its (at most PER) loads of each operand in
// flight before it stores any
template <int ROWS, int STRIDE, int NT, bool BY_ROWS>
__device__ __forceinline__ void stage_in(const int* p, const int* q,
                                         const AddOffsets& ofs, i64 prs,
                                         i64 qrs, int nvalid) {
  constexpr int PER = (ADDS * ROWS + NT - 1) / NT;
  int vp[PER], vq[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(u, a, r);
    const bool ok = a < nvalid && threadIdx.x + u * NT < ADDS * ROWS;
    vp[u] = ok ? p[ofs.p[a] + r * prs] : 0;
    vq[u] = ok ? q[ofs.q[a] + r * qrs] : 0;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (threadIdx.x + u * NT >= ADDS * ROWS) break;
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(u, a, r);
    psm[a * STRIDE + r] = vp[u];
    psm[a * STRIDE + ROWS + r] = vq[u];
  }
}

// Store the results in the regions at `off` to out (B, ROWS, T)
template <int ROWS, int STRIDE, int NT, bool BY_ROWS>
__device__ __forceinline__ void store_out(int off, int* out,
                                          const AddOffsets& ofs, i64 T,
                                          int nvalid) {
  constexpr int PER = (ADDS * ROWS + NT - 1) / NT;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (threadIdx.x + u * NT >= ADDS * ROWS) break;
    int a, r;
    point_elem<ROWS, NT, BY_ROWS>(u, a, r);
    if (a < nvalid) out[ofs.o[a] + r * T] = psm[a * STRIDE + off + r];
  }
}

// G1: out (B, 63, T) contiguous = p + q; p and q are read through batch,
// row and lane strides (a stride of 0 reads a broadcast operand in place).
// Region of an add (ints), warp j (= role) of its team of three:
//   0 P, 63 Q                      staged operands
//   126 + 21j  T_j = X1X2, Y1Y2, Z1Z2;  189 + 21j  S_j = (X1+Y1)(X2+Y2),
//              (Y1+Z1)(Y2+Z2), (Z1+X1)(Z2+X2)   (round 1: warp j; S_j's
//              operand sums are first put in the two slots it fills)
//   after round 1: 21j t3, t4, y3 (warp j); 63 x3 (warp 0); 252 t2b =
//   t2*b3, 84 z3, 105 t1' (warp 1); 273 y3b = y3*b3, 294 -y3b (warp 2)
//   126 + 21j  output coordinate j (round 3: warp j, two lazy terms)
// Constants after the regions: b3.  Per thread: at most 3 products and 2
// lazy terms, 4,893 of the add's 13,566 multiply-adds.
template <bool BY_ROWS>
__global__ void __launch_bounds__(G1_WARPS * 32)
padd_g1_kernel(const int* __restrict__ p, const int* __restrict__ q,
               int* __restrict__ out, i64 total, i64 T, i64 pbs, i64 prs,
               i64 pts, i64 qbs, i64 qrs, i64 qts) {
  __shared__ AddOffsets ofs;
  add_offsets(ofs, total, T, 63, pbs, pts, qbs, qts);
  __syncthreads();
  const i64 first = (i64)blockIdx.x * ADDS;
  const int nvalid = (int)(total - first < ADDS ? total - first : ADDS);
  const int KC = ADDS * G1_STRIDE;
  stage_in<63, G1_STRIDE, G1_WARPS * 32, BY_ROWS>(p, q, ofs, prs, qrs,
                                                  nvalid);
  if (threadIdx.x < NL) psm[KC + threadIdx.x] = EC_B3G1[threadIdx.x];
  __syncthreads();
  const int j = threadIdx.x >> 5, j1 = j == 2 ? 0 : j + 1;
  const int base = (threadIdx.x & 31) * G1_STRIDE;
  int* s = psm + base;
  // round 1
  s_add<NL>(s + NL * j, s + NL * j1, s + 126 + NL * j);
  s_add<NL>(s + 63 + NL * j, s + 63 + NL * j1, s + 189 + NL * j);
  mul1(base + 126 + NL * j, base + 189 + NL * j, base + 189 + NL * j);
  mul1(base + NL * j, base + 63 + NL * j, base + 126 + NL * j);
  __syncthreads();
  // t3, t4, y3; x3; round 2: t2b = t2*b3 and y3b = y3*b3
  s_cross<NL>(s + 189 + NL * j, s + 126 + NL * j, s + 126 + NL * j1,
              s + NL * j);
  if (j == 0) {
    s_triple<NL>(s + 126, s + 63);
  } else if (j == 1) {
    mul1(base + 168, KC, base + 252);
    s_add<NL>(s + 147, s + 252, s + 84);
    s_sub<NL>(s + 147, s + 252, s + 105);
  } else {
    mul1(base + 2 * NL, KC, base + 273);
    s_neg(s + 273, s + 294);
  }
  __syncthreads();
  // round 3: X = t3*t1' + t4*(-y3b), Y = y3b*x3 + t1'*z3, Z = z3*t4 + x3*t3
  if (j == 0)
    lazy2(base, base + 105, base + 21, base + 294, base + 126);
  else if (j == 1)
    lazy2(base + 273, base + 63, base + 105, base + 84, base + 147);
  else
    lazy2(base + 84, base + 21, base + 63, base, base + 168);
  __syncthreads();
  store_out<63, G1_STRIDE, G1_WARPS * 32, BY_ROWS>(126, out, ofs, T, nvalid);
}

// Round 3 over Fq2 (_round3_fq2): output component w = 2*o + c (o = X, Y,
// Z; c = re, im) is the reduction of four lazy terms; the pairs are region
// offsets (see padd_g2_kernel), negations already taken.
__constant__ short G2_ROUND3[G2_WARPS][8] = {
    {0, 357, 21, 420, 42, 441, 63, 294},      // X re
    {0, 378, 21, 357, 42, 462, 63, 441},      // X im
    {273, 126, 294, 210, 357, 315, 378, 399}, // Y re
    {273, 147, 294, 126, 357, 336, 378, 315}, // Y im
    {315, 42, 336, 189, 126, 0, 147, 168},    // Z re
    {315, 63, 336, 42, 126, 21, 147, 0}};     // Z im

// G2: out (B, 126, T) contiguous = p + q, strides as for G1.  Fq2 values
// are 42 ints (re, im).  Region of an add (ints), warp w of its team:
//   0 P, 126 Q                     staged operands
//   252 + 42c  a'_c = P_c + P_c+1, 378 + 42c  b'_c = Q_c + Q_c+1,
//   504 + 21c  -im(Q_c), 567 + 21c  -im(b'_c)     (warps c and 3 + c)
//   630 + 21w  T component w, 756 + 21w  S component w   (round 1: warp
//              w = 2c + comp, comp of T_c = P_c Q_c and S_c = a'_c b'_c)
//   after round 1: 0, 42, 84 t3, t4, y3; 126 x3; 168 -im(t3); 189
//   -im(t4); 210 -im(x3); 231 t2b; 273 y3b (round 2: warps 0-3); 315 z3;
//   357 t1'; 399 -im(z3); 420 -im(t1'); 441 -re(y3b); 462 -im(y3b)
//   630 + 21w  output component w (round 3: four lazy terms)
// Constants after the regions: b3 (re, im), -im(b3).  Per thread: 8 + 2 +
// 4 lazy terms and 4 reductions, 7,098 of the add's 39,480 multiply-adds.
template <bool BY_ROWS>
__global__ void __launch_bounds__(G2_WARPS * 32)
padd_g2_kernel(const int* __restrict__ p, const int* __restrict__ q,
               int* __restrict__ out, i64 total, i64 T, i64 pbs, i64 prs,
               i64 pts, i64 qbs, i64 qrs, i64 qts) {
  __shared__ AddOffsets ofs;
  add_offsets(ofs, total, T, 126, pbs, pts, qbs, qts);
  __syncthreads();
  const i64 first = (i64)blockIdx.x * ADDS;
  const int nvalid = (int)(total - first < ADDS ? total - first : ADDS);
  const int KC = ADDS * G2_STRIDE;
  stage_in<126, G2_STRIDE, G2_WARPS * 32, BY_ROWS>(p, q, ofs, prs, qrs,
                                                   nvalid);
  if (threadIdx.x < 2 * NL) psm[KC + threadIdx.x] = EC_B3G2[threadIdx.x];
  if (threadIdx.x == 2 * NL) {
    int x[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) x[k] = FQ_SUBD2[k] - EC_B3G2[NL + k];
    weak_norm<NL>(x);
    store_n<NL>(psm + KC + 2 * NL, x);
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int base = (threadIdx.x & 31) * G2_STRIDE;
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
    lazy2(a, b + (comp ? NL : 0), a + NL, comp ? b : base + 504 + NL * c,
          base + 630 + NL * w);
    const int sa = base + 252 + 42 * c, sb = base + 378 + 42 * c;
    lazy2(sa, sb + (comp ? NL : 0), sa + NL,
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
    lazy2(a, KC + (comp ? NL : 0), a + NL, comp ? KC : KC + 2 * NL,
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
  {  // round 3
    prod(4, true, base + G2_ROUND3[w][0], base + G2_ROUND3[w][1],
         base + G2_ROUND3[w][2], base + G2_ROUND3[w][3],
         base + G2_ROUND3[w][4], base + G2_ROUND3[w][5],
         base + G2_ROUND3[w][6], base + G2_ROUND3[w][7],
         base + 630 + NL * w);
  }
  __syncthreads();
  store_out<126, G2_STRIDE, G2_WARPS * 32, BY_ROWS>(630, out, ofs, T,
                                                    nvalid);
}

// out (B, rows, h) = x[..., :h] + x[..., h:], x (B, rows, 2h) contiguous
template <int K>
__global__ void __launch_bounds__(THREADS)
fold_padd_kernel(const int* __restrict__ x, int* __restrict__ out,
                 const int* __restrict__ consts, i64 B, i64 h) {
  __shared__ int C[EC_CONSTS];
  stage_consts(consts, C, EC_CONSTS);
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * h) return;
  const i64 b = idx / h, j = idx % h;
  const int* xb = x + b * (3 * K * NL) * (2 * h);
  padd_point<K>(xb + j, 2 * h, xb + h + j, 2 * h,
                out + b * (3 * K * NL) * h + j, h, C);
}

// out (B, rows, h) projective = x[..., :h] (+) x[..., h:], x (B, arows,
// 2h) affine, contiguous
template <int K>
__global__ void __launch_bounds__(THREADS)
fold_padd_aa_kernel(const int* __restrict__ x, int* __restrict__ out,
                    const int* __restrict__ consts, i64 B, i64 h) {
  __shared__ int C[EC_CONSTS];
  stage_consts(consts, C, EC_CONSTS);
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * h) return;
  const i64 b = idx / h, j = idx % h;
  const int* xb = x + b * (2 * K * NL + 1) * (2 * h);
  padd_aa_point<K>(xb + j, xb + h + j, 2 * h,
                   out + b * (3 * K * NL) * h + j, h, C);
}


// launch one form of padd (G1 or G2, planes of T == 1 or not)
template <typename Kernel>
static int launch_padd(Kernel kernel, int warps, int smem, const int* p,
                       const int* q, int* out, i64 total, i64 T, i64 pbs,
                       i64 prs, i64 pts, i64 qbs, i64 qrs, i64 qts,
                       cudaStream_t s) {
  // shared memory above 48 KB must be asked for (per kernel and device)
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((total + ADDS - 1) / ADDS);
  kernel<<<blocks, warps * 32, smem, s>>>(p, q, out, total, T, pbs, prs, pts,
                                          qbs, qrs, qts);
  return (int)cudaGetLastError();
}

extern "C" {

int zk_mont_mul(const int* a, const int* b, int* out, const int* consts,
                i64 d0, i64 d1, i64 d2, i64 T, i64 sa0, i64 sa1, i64 sa2,
                i64 sal, i64 sat, i64 sb0, i64 sb1, i64 sb2, i64 sbl, i64 sbt,
                void* stream) {
  const i64 total = d0 * d1 * d2 * T;
  mont_mul_kernel<<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, consts, d1, d2, T, total, sa0, sa1, sa2, sal, sat, sb0, sb1,
      sb2, sbl, sbt);
  return (int)cudaGetLastError();
}

int zk_padd(int k, const int* p, const int* q, int* out, i64 B, i64 T,
            i64 pbs, i64 prs, i64 pts, i64 qbs, i64 qrs, i64 qts,
            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 total = B * T;
  if (k == 1)
    return T == 1 ? launch_padd(padd_g1_kernel<true>, G1_WARPS, G1_SMEM, p,
                                q, out, total, T, pbs, prs, pts, qbs, qrs,
                                qts, s)
                  : launch_padd(padd_g1_kernel<false>, G1_WARPS, G1_SMEM, p,
                                q, out, total, T, pbs, prs, pts, qbs, qrs,
                                qts, s);
  return T == 1 ? launch_padd(padd_g2_kernel<true>, G2_WARPS, G2_SMEM, p, q,
                              out, total, T, pbs, prs, pts, qbs, qrs, qts, s)
                : launch_padd(padd_g2_kernel<false>, G2_WARPS, G2_SMEM, p, q,
                              out, total, T, pbs, prs, pts, qbs, qrs, qts, s);
}

int zk_fold_padd(int k, const int* x, int* out, const int* consts, i64 B,
                 i64 h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fold_padd_kernel<1><<<blocks_for(B * h), THREADS, 0, s>>>(x, out, consts,
                                                              B, h);
  else
    fold_padd_kernel<2><<<blocks_for(B * h), THREADS, 0, s>>>(x, out, consts,
                                                              B, h);
  return (int)cudaGetLastError();
}

int zk_fold_padd_aa(int k, const int* x, int* out, const int* consts, i64 B,
                    i64 h, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    fold_padd_aa_kernel<1><<<blocks_for(B * h), THREADS, 0, s>>>(x, out,
                                                                 consts, B, h);
  else
    fold_padd_aa_kernel<2><<<blocks_for(B * h), THREADS, 0, s>>>(x, out,
                                                                 consts, B, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
