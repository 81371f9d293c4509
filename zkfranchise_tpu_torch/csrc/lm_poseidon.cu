// Hand-written Hopper (sm_90a) kernels for the Poseidon permutation over
// BN254 Fr on the limb-major core (layout and device functions:
// lm_device.cuh), and for the witness's SMT chains built on it.
//
// Kernels and the TPU kernels they replace:
//   zk_poseidon  <- mont_mul (zkfranchise_tpu/ops/pallas/lm_kernels.py
//                   _mont_mul_kernel) as the witness launches it: three
//                   products a S-box and t a row of the MDS mix, each one
//                   launch (ops/poseidon.py, models/census.py
//                   eval_poseidon_trace).  Here the whole permutation of
//                   width t (3, 4 or 5) runs in ONE launch for every lane.
//   zk_smt_fill, <- the per-level loop of zkfranchise_tpu/models/census.py
//   zk_smt_levels   eval_smt_trace, one tree at a time: a permutation and
//                   three products a level, each its own launch.  Here
//                   the levels above each lane's leaf are hashed in ONE
//                   launch for every lane of every tree (the permutation
//                   below as a device function), and the levels at or
//                   below it, which hash zeros, are copied from a table by
//                   one wide launch (the section before the entry points).
//
// It repeats the plain version's steps in order (ops/cuda/lm_kernels.py
// permutation_ref, poseidon_trace_ref), so every limb equals it: a round's
// constant add and one weak_norm round; x^2, x^4, x^5 by the device
// mont_mul, on every element in a full round and on element 0 in a partial
// one (the trace rows in build_poseidon's order: element j's x^2, x^4, x^5
// at 3j, 3j + 1, 3j + 2 of the round's rows); the mix as t products
// M[i][j] * s[j] summed lazily in int32, then one weak_norm round.
//
// Design.  A block owns 32 lanes and has t warps: warp i holds state
// element i of its 32 lanes in registers, so all lanes of a warp play the
// same role, and a partial round idles whole warps, never half of one.
// After the S-box each warp writes its element to one of two state
// buffers in shared memory (lane-minor: the 32 lanes of a warp touch 32
// banks), one __syncthreads(), then each warp forms its row of the mix
// from all t elements.  The buffers alternate by round, so one barrier a
// round suffices: a warp can only write a buffer again two rounds later,
// after every warp has passed the barrier between.  The round constants
// (rounds, t, 21) and the MDS matrix (t, t, 21), at most 30 KB, are staged
// once per block into shared memory, where every read of a warp is one
// broadcast (all its lanes read the same constant); the state buffers, 27
// KB at t = 5, lie after them.  Trace and output rows are lane-minor, so
// every load and store of device memory is coalesced.
//
// What bounds it: latency.  A lane's permutation is a chain of 65-68
// rounds, each 3 + t products in sequence for warp 0 (the S-box, then its
// row of the mix), 1,113 multiply-adds a product; at the witness's 128
// lanes the launch fills 4 of 132 SMs with t warps each.  Its bytes and
// operations bound is a few microseconds; the yardstick that means
// something is a mont_chain of as many dependent products at the same
// width.  One thread per lane holding all t x 21 limbs and a product's
// registers would spill; a warp per element keeps one element a thread.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

#define LANES 32
#define R_F 8

extern __shared__ int psmem[];

// One permutation of width TW by the TW warps of a block: warp e holds
// element e of its 32 lanes' states in s[] and leaves the new element
// there.  Every thread of the block calls it (a barrier a round).  C: the
// field block (p, n' first); CR (R_F + r_p, TW, 21) and MM (TW, TW, 21):
// the round constants and the MDS matrix, and S the two state buffers, in
// shared memory.  tr, if not null: where this lane's trace goes (x^2, x^4,
// x^5 of each S-box, a row every NL * T ints and a limb every T).
template <int TW>
__device__ __forceinline__ void permute(int* s, int r_p, const int* C,
                                        const int* CR, const int* MM, int* S,
                                        int* tr, i64 T) {
  const int rounds = R_F + r_p, half = R_F / 2;
  const int e = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int row = 0;                           // the round's first trace row
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < NL; ++k) s[k] += CR[(r * TW + e) * NL + k];
    weak_norm<NL>(s);
    const bool full = r < half || r >= half + r_p;
    if (full || e == 0) {                // the S-box: x^2, x^4, x^5
      int y[NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) y[k] = s[k];
#pragma unroll 1
      for (int i = 0; i < 3; ++i) {
        int b[NL], z[NL];
#pragma unroll
        for (int k = 0; k < NL; ++k) b[k] = i == 2 ? s[k] : y[k];
        mont_mul(y, b, C, z);
#pragma unroll
        for (int k = 0; k < NL; ++k) y[k] = z[k];
        if (tr != nullptr) {
          int* t = tr + (i64)(row + 3 * e + i) * NL * T;
#pragma unroll
          for (int k = 0; k < NL; ++k) t[k * T] = y[k];
        }
      }
#pragma unroll
      for (int k = 0; k < NL; ++k) s[k] = y[k];
    }
    row += full ? 3 * TW : 3;
    int* buf = S + (r & 1) * TW * NL * LANES;
#pragma unroll
    for (int k = 0; k < NL; ++k) buf[(e * NL + k) * LANES + lane] = s[k];
    __syncthreads();
    // the mix: row e of M times the state, summed lazily
    int acc[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) acc[k] = 0;
#pragma unroll 1
    for (int j = 0; j < TW; ++j) {
      int b[NL], z[NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) b[k] = buf[(j * NL + k) * LANES + lane];
      mont_mul(MM + (e * TW + j) * NL, b, C, z);
#pragma unroll
      for (int k = 0; k < NL; ++k) acc[k] += z[k];
    }
    weak_norm<NL>(acc);
#pragma unroll
    for (int k = 0; k < NL; ++k) s[k] = acc[k];
  }
}

// (rounds, t, 21) round constants and the (t, t, 21) MDS matrix into
// shared memory, and the first `rows` rows of the field block
template <int TW>
__device__ __forceinline__ void stage_tables(const int* consts,
                                             const int* c_mont,
                                             const int* m_mont, int r_p,
                                             int rows, int* C, int* CR,
                                             int* MM) {
  const int rounds = R_F + r_p;
  for (int i = threadIdx.x; i < rows * NL; i += blockDim.x) C[i] = consts[i];
  for (int i = threadIdx.x; i < rounds * TW * NL; i += blockDim.x)
    CR[i] = c_mont[i];
  for (int i = threadIdx.x; i < TW * TW * NL; i += blockDim.x)
    MM[i] = m_mont[i];
}

// x (n_in, 21, T): the state's elements zero_first .. t-1 (element 0 is
// zero when zero_first is 1); out (t or 1, 21, T): the whole state or
// element 0 (whole 0); trace (3 (R_F t + r_p), 21, T) or null.  consts:
// the field block (p, n' first); c_mont (R_F + r_p, t, 21) and m_mont (t,
// t, 21) in Montgomery form.
template <int TW>
__global__ void __launch_bounds__(TW * 32)
poseidon_kernel(const int* __restrict__ x, int* __restrict__ out,
                int* __restrict__ trace, const int* __restrict__ consts,
                const int* __restrict__ c_mont,
                const int* __restrict__ m_mont, int r_p, i64 T,
                int zero_first, int whole) {
  const int rounds = R_F + r_p;
  int* C = psmem;                        // p, n'
  int* CR = C + 2 * NL;                  // round constants
  int* MM = CR + rounds * TW * NL;       // MDS matrix
  int* S = MM + TW * TW * NL;            // two state buffers
  stage_tables<TW>(consts, c_mont, m_mont, r_p, 2, C, CR, MM);
  const int e = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 g = (i64)blockIdx.x * LANES + lane;
  const bool ok = g < T;
  const int src = e - zero_first;
  int s[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k)
    s[k] = ok && src >= 0 ? x[((i64)src * NL + k) * T + g] : 0;
  __syncthreads();
  permute<TW>(s, r_p, C, CR, MM, S,
              trace != nullptr && ok ? trace + g : nullptr, T);
  if (ok && (whole || e == 0)) {
#pragma unroll
    for (int k = 0; k < NL; ++k) out[((i64)e * NL + k) * T + g] = s[k];
  }
}

// ---------------------------------------------------------------------------
// the witness's SMT chains (models/census.py eval_smt_trees; plain
// versions ops/cuda/lm_kernels.py smt_fill_ref and smt_levels_ref)
// ---------------------------------------------------------------------------
// n trees over the same T voters ride one lane axis of n T lanes: lane g
// is voter v = g mod T of tree k = g / T.  Tree k's witness block is
// block[k], rows of 21 limbs (a limb every T ints): lev (L + 1) | the
// leaf's trace | c_top | then for each level i = L - 1 .. 0 its LR rows
// m_sw | the t = 3 trace | m1 | m2 (build_smt_inclusion's order).  A lane
// of depth d (one past its last nonzero sibling) hashes the levels i < d
// only: at i >= d its sibling is zero and the rows are a constant of
// (i == L - 1, key bit i), the table (4, LR, 21), entry 2 (i < L - 1) +
// bit; m1 of level d is leaf R, written over the table's zero.

// rows of one level: m_sw, the trace, m1, m2
__host__ __device__ inline int level_rows(int r_p) {
  return 3 + 3 * (R_F * 3 + r_p);
}

// every level i >= d of every lane, from the table.  blockIdx.y is the
// tree and the level (k L + j, i = L - 1 - j); the x blocks stride over
// that level's LR x 21 x T ints, which lie in one run.
__global__ void __launch_bounds__(256)
smt_fill_kernel(const int* __restrict__ bits, const int* __restrict__ depth,
                const int* __restrict__ table, int* __restrict__ block,
                int L, unsigned T, i64 rows, i64 head, int lr) {
  const int k = blockIdx.y / L, j = blockIdx.y - k * L, i = L - 1 - j;
  const unsigned per = (unsigned)lr * NL * T;
  int* dst = block + ((i64)k * rows + head + (i64)j * lr) * NL * T;
  const int* d = depth + (i64)k * T;
  const int* bit = bits + (i64)i * T;
  const int* tab = table + (j == 0 ? 0 : 2) * lr * NL;
  for (unsigned x = blockIdx.x * blockDim.x + threadIdx.x; x < per;
       x += gridDim.x * blockDim.x) {
    const unsigned q = x / T, v = x - q * T;
    if (i >= d[v]) dst[x] = tab[bit[v] * lr * NL + q];
  }
}

// the levels i < d of every lane: 32 lanes a block, and the three warps
// of the t = 3 permutation, walking i = dmax - 1 .. 0 where dmax is the
// block's deepest lane.  A lane joins at i = d - 1, from c = leaf R at d =
// L (c_top) and else from c = leaf R + m2 of its level d.  Warps 1 and 2
// form left and right from c (each its own, both m_sw), warp 0 m2 and the
// next c from the hash, which it hands on in shared memory.  Also writes
// c_top, m1 of level d, the roots (21, n T) and each lane's count of the
// levels it hashed.  bits (>= L, T) 0/1; sib (L, 21, n T) and leaf (21,
// n T) Montgomery; depth (n T).
__global__ void __launch_bounds__(3 * 32)
smt_levels_kernel(const int* __restrict__ bits, const int* __restrict__ sib,
                  const int* __restrict__ leaf,
                  const int* __restrict__ depth,
                  const int* __restrict__ table, int* __restrict__ block,
                  int* __restrict__ root, int* __restrict__ hashed,
                  const int* __restrict__ consts,
                  const int* __restrict__ c_mont,
                  const int* __restrict__ m_mont, int r_p, int L, i64 T,
                  i64 nT, i64 rows, i64 head) {
  const int rounds = R_F + r_p, lr = level_rows(r_p);
  int* C = psmem;                        // p, n', sub_d, one
  int* CR = C + 4 * NL;                  // round constants
  int* MM = CR + rounds * 3 * NL;        // MDS matrix
  int* S = MM + 9 * NL;                  // two state buffers
  int* E1 = S + 2 * 3 * NL * LANES;      // sub_n(one, 0): m2's factor
  int* CL = E1 + NL;                     // each lane's c, lane-minor
  __shared__ int dmax;
  stage_tables<3>(consts, c_mont, m_mont, r_p, 4, C, CR, MM);
  if (threadIdx.x == 0) dmax = 0;
  __syncthreads();
  const int e = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 g = (i64)blockIdx.x * LANES + lane;
  const bool ok = g < nT;
  const i64 k = ok ? g / T : 0, v = ok ? g - k * T : 0;
  const int d = ok ? depth[g] : 0;
  int* const out = block + k * rows * NL * T + v;   // row 0, limb 0
  if (threadIdx.x == 0) {
    int x[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) x[j] = C[C_ONE + j] + C[C_SUBD + j];
    weak_norm<NL>(x);
#pragma unroll
    for (int j = 0; j < NL; ++j) E1[j] = x[j];
  }
  if (e == 0) {
    if (ok) atomicMax(&dmax, d);
    int lf[NL], c[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) lf[j] = ok ? leaf[j * nT + g] : 0;
    mont_mul(C + C_ONE, lf, C, lf);      // leaf R
    if (d < L) {
      const int b = ok ? bits[(i64)d * T + v] : 0;
      const int* m2 = table + ((d == L - 1 ? 0 : 2) + b) * lr * NL +
                      (lr - 1) * NL;
#pragma unroll
      for (int j = 0; j < NL; ++j) c[j] = lf[j] + m2[j];
      weak_norm<NL>(c);
    } else {
#pragma unroll
      for (int j = 0; j < NL; ++j) c[j] = lf[j];
    }
    if (ok) {
      int* top = out + (head - 1) * NL * T;
#pragma unroll
      for (int j = 0; j < NL; ++j) top[j * T] = d == L ? lf[j] : 0;
      if (d < L) {
        int* m1 = out + (head + (i64)(L - 1 - d) * lr + lr - 2) * NL * T;
#pragma unroll
        for (int j = 0; j < NL; ++j) m1[j * T] = lf[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) CL[j * LANES + lane] = c[j];
  }
  __syncthreads();
  const int levels = dmax;
  int count = 0;
#pragma unroll 1
  for (int i = levels - 1; i >= 0; --i) {
    const bool on = ok && i < d;
    int* lvl = out + (head + (i64)(L - 1 - i) * lr) * NL * T;
    int s[NL];
    if (e == 0) {
#pragma unroll
      for (int j = 0; j < NL; ++j) s[j] = 0;
    } else {
      int c[NL], sm[NL], t[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        c[j] = CL[j * LANES + lane];
        sm[j] = ok ? sib[((i64)i * NL + j) * nT + g] : 0;
        t[j] = sm[j] + (C[C_SUBD + j] - c[j]);
      }
      weak_norm<NL>(t);                  // sub_n(s, c)
      if (ok && bits[(i64)i * T + v]) {
        mont_mul(C + C_ONE, t, C, t);    // m_sw
      } else {
#pragma unroll
        for (int j = 0; j < NL; ++j) t[j] = 0;
      }
#pragma unroll
      for (int j = 0; j < NL; ++j) s[j] = c[j] + t[j];
      weak_norm<NL>(s);                  // left
      if (e == 1) {
        if (on) {
#pragma unroll
          for (int j = 0; j < NL; ++j) lvl[j * T] = t[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NL; ++j)
          s[j] = (sm[j] + c[j]) + (C[C_SUBD + j] - s[j]);
        weak_norm<NL>(s);                // right = sub_n(s + c, left)
        if (on) {
          int* m1 = lvl + (i64)(lr - 2) * NL * T;
#pragma unroll
          for (int j = 0; j < NL; ++j) m1[j * T] = 0;
        }
      }
    }
    permute<3>(s, r_p, C, CR, MM, S, on ? lvl + (i64)NL * T : nullptr, T);
    if (e == 0 && on) {
      int m2[NL];
      mont_mul(E1, s, C, m2);
      int* o = lvl + (i64)(lr - 1) * NL * T;
#pragma unroll
      for (int j = 0; j < NL; ++j) o[j * T] = m2[j];
      weak_norm<NL>(m2);                 // the next c: m1 + m2, m1 zero
#pragma unroll
      for (int j = 0; j < NL; ++j) CL[j * LANES + lane] = m2[j];
      ++count;
    }
    __syncthreads();
  }
  if (e == 0 && ok) {
#pragma unroll
    for (int j = 0; j < NL; ++j) root[j * nT + g] = CL[j * LANES + lane];
    hashed[g] = count;
  }
}

template <int TW>
static int launch(const int* x, int* out, int* trace, const int* consts,
                  const int* c_mont, const int* m_mont, int r_p, i64 T,
                  int zero_first, int whole, cudaStream_t s) {
  const int smem = 4 * (2 * NL + (R_F + r_p) * TW * NL + TW * TW * NL +
                        2 * TW * NL * LANES);
  // shared memory above 48 KB must be asked for (t = 5)
  cudaError_t rc = cudaFuncSetAttribute(
      poseidon_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned blocks = (unsigned)((T + LANES - 1) / LANES);
  poseidon_kernel<TW><<<blocks, TW * 32, smem, s>>>(
      x, out, trace, consts, c_mont, m_mont, r_p, T, zero_first, whole);
  return (int)cudaGetLastError();
}

extern "C" {

int zk_poseidon(int t, const int* x, int* out, int* trace, const int* consts,
                const int* c_mont, const int* m_mont, int r_p, i64 T,
                int zero_first, int whole, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (t) {
    case 3: return launch<3>(x, out, trace, consts, c_mont, m_mont, r_p, T,
                             zero_first, whole, s);
    case 4: return launch<4>(x, out, trace, consts, c_mont, m_mont, r_p, T,
                             zero_first, whole, s);
    case 5: return launch<5>(x, out, trace, consts, c_mont, m_mont, r_p, T,
                             zero_first, whole, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int zk_smt_fill(const int* bits, const int* depth, const int* table,
                int* block, int r_p, int L, i64 T, int n, i64 head,
                void* stream) {
  const int lr = level_rows(r_p);
  const i64 per = (i64)lr * NL * T;
  if (L < 1 || n < 1 || T < 1 || (i64)n * L > 65535 || per >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((per + 255) / 256), (unsigned)(n * L));
  smt_fill_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      bits, depth, table, block, L, (unsigned)T, head + (i64)L * lr, head,
      lr);
  return (int)cudaGetLastError();
}

int zk_smt_levels(const int* bits, const int* sib, const int* leaf,
                  const int* depth, const int* table, int* block, int* root,
                  int* hashed, const int* consts, const int* c_mont,
                  const int* m_mont, int r_p, int L, i64 T, int n, i64 head,
                  void* stream) {
  if (L < 1 || n < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int lr = level_rows(r_p), rounds = R_F + r_p;
  const int smem = 4 * (4 * NL + rounds * 3 * NL + 9 * NL +
                        2 * 3 * NL * LANES + NL + NL * LANES);
  cudaError_t rc = cudaFuncSetAttribute(
      smt_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const i64 nT = (i64)n * T;
  smt_levels_kernel<<<(unsigned)((nT + LANES - 1) / LANES), 3 * 32, smem,
                      (cudaStream_t)stream>>>(
      bits, sib, leaf, depth, table, block, root, hashed, consts, c_mont,
      m_mont, r_p, L, T, nT, head + (i64)L * lr, head);
  return (int)cudaGetLastError();
}

}  // extern "C"
