// Hand-written Hopper (sm_90a) kernels for the batch inversion and the
// in-kernel chains over the limb-major BN254 core (layout and device
// functions: lm_device.cuh).
//
// Kernels and the TPU kernels they replace:
//   zk_fold_mul    <- fold_mul (zkfranchise_tpu/ops/pallas/lm_kernels.py
//                     _fold_mul_kernel): out[j] = x[j] * x[j + m/2], the
//                     product tree of batch_inv
//   zk_inv         <- inv (lm_kernels.py _inv_kernel): a^(p-2) by
//                     square-and-multiply, exponent bits shared by all
//                     lanes; inv(0) = 0
//   zk_mont_chain  <- pallas_chain (scripts/micro_montmul.py chain_kernel):
//                     x = a, then `iters` times x = x * b
// (zk_scalar_mul, the double-and-add, runs on the cooperative add in
// lm_kernels.cu.)
//
// Design of fold_mul and mont_chain: one thread per lane, limbs in
// registers, the plain PyTorch versions' steps in the same order, so every
// output limb equals the plain version's.  What bounds them on an H100:
// integer multiply-adds, 1,113 per (schoolbook) Montgomery product against
// 168-252 bytes of traffic.  fold_mul fills the card like mont_mul;
// mont_chain keeps x in registers across the chain and so shows the
// card's multiply-add rate without memory traffic.
//
// Design of inv: a latency chain, so a warp per lane.  inv is called with
// as many lanes as there are rows in a batch (128), each a chain of 253
// squares and a product per set bit of p - 2 (110 for Fq), every one
// dependent on the one before: one thread a lane put all 128 lanes on ONE
// SM, 1.75 us a product.  Here a lane is a warp (a block of 32 threads),
// so 128 lanes run on 128 SMs, and each product is spread over the warp
// (warp_mont_mul): thread k holds limb k of each operand and forms columns
// k and k + 32 of the 43, its operands' limbs read from the warp's rows in
// shared memory (one broadcast, one shifted between zero pads) and p and
// n' from registers it fills once; the weak_norm rounds read a window of
// lower columns fetched by shuffles in one stage (the plain round reads
// only the old limbs); the low product m = t*n' is spread the same way;
// "any low limb nonzero" is a ballot.  Every column is the same exact integer as the plain version's
// and every round the same, so every intermediate limb equals it.  The
// exponent bits are staged in shared memory and are the same for every
// thread, so each branch on a bit is uniform; the product that a zero bit
// would discard is not computed, nor is the last square.  Where a bit is
// set, acc*base and base*base do not depend on each other: the warp runs
// them side by side, interleaved, to cover each other's latency.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

#define MAX_BITS 256

// out (B, 21, h) = x[..., :h] * x[..., h:], x (B, 21, 2h) contiguous;
// consts holds p and n' of the field (21 limbs each)
__global__ void __launch_bounds__(THREADS)
fold_mul_kernel(const int* __restrict__ x, int* __restrict__ out,
                const int* __restrict__ consts, i64 B, i64 h) {
  __shared__ int C[2 * NL];
  stage_consts(consts, C, 2 * NL);
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * h) return;
  const i64 b = idx / h, j = idx % h;
  const int* xb = x + b * NL * (2 * h) + j;
  int u[NL], v[NL], z[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    u[k] = xb[k * 2 * h];
    v[k] = xb[k * 2 * h + h];
  }
  mont_mul(u, v, C, z);
  int* po = out + b * NL * h + j;
#pragma unroll
  for (int k = 0; k < NL; ++k) po[k * h] = z[k];
}

// ---------------------------------------------------------------------------
// the warp product: one Montgomery product spread over 32 threads
// ---------------------------------------------------------------------------

#define FULL_MASK 0xffffffffu

// p and n' as lane k's products need them, filled once: p[i] = limb
// k - i of p for column k (k >= i) or limb k + 32 - i for column k + 32
// (k < i); np[i] = limb k - i of n' for m's limb k (k < 21); 0 where the
// limb does not exist
struct WarpConsts {
  int p[NL], np[NL];
};

__device__ __forceinline__ void warp_consts(const int* C, int lane,
                                            WarpConsts& w) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int j = lane - i, jp = j >= 0 ? j : j + 32;
    w.p[i] = jp < NL ? C[C_P + jp] : 0;
    w.np[i] = j >= 0 && lane < NL ? C[C_NP + j] : 0;
  }
}

// The warp's rows in shared memory, one set for each of two products side
// by side: ys, an operand whose limb i every lane reads (a broadcast), and
// xs, the other operand's limbs at 32..52 between zero pads, so that lane
// k reads limb k - i at 32 + k - i and limb k + 32 - i at 64 + k - i with
// no test of range.  Shuffles in their place read much slower on an H100:
// a shuffle costs more than a shared-memory read here.
struct WarpRows {
  int ys[2][32];
  int xs[2][96];
};

// R weak_norm rounds over 43 columns, lane k holding column k in lo and
// column k + 32 in hi: the R columns below each are fetched at once (one
// shuffle stage) and the rounds run on that window, each round reading
// only the old limbs as the plain round does, so the limbs are the plain
// version's.  The carry out of column 42 lands in lane 11's hi, which
// nothing reads (the plain version drops it).
template <int N, int R>
__device__ __forceinline__ void warp_wn43(int* lo, int* hi, int lane) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    int wl[R + 1], wh[R + 1];
    wl[R] = lo[q];
    wh[R] = hi[q];
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      const int src = (lane - d) & 31;
      const int sl = __shfl_sync(FULL_MASK, lo[q], src);
      const int sh = __shfl_sync(FULL_MASK, hi[q], src);
      wl[R - d] = lane >= d ? sl : 0;
      wh[R - d] = lane >= d ? sh : sl;
    }
#pragma unroll
    for (int r = 1; r <= R; ++r) {
#pragma unroll
      for (int j = R; j >= r; --j) {
        wl[j] = (wl[j] & MASK) + (wl[j - 1] >> LB);
        wh[j] = (wh[j] & MASK) + (wh[j - 1] >> LB);
      }
    }
    lo[q] = wl[R];
    hi[q] = wh[R];
  }
}

// r[q] = a[q] * b[q] * R^-1 mod p for N independent products at once,
// operands and results as limb k at lane k (0 past limb 20): the steps of
// lm.mont_reduce over the wide product, each limb the plain version's.
// Column sums are exact, so each is formed as two half sums (a shorter
// dependent chain); a column k + 32 has terms only from i >= 12.
template <int N>
__device__ __forceinline__ void warp_mont_mul(const int* a, const int* b,
                                              int* r, const WarpConsts& w,
                                              WarpRows& s, int lane) {
  int lo[N], hi[N], l2[N], h2[N], m[N], m2[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    lo[q] = hi[q] = l2[q] = h2[q] = m[q] = m2[q] = 0;
    s.ys[q][lane] = b[q];
    s.xs[q][32 + lane] = a[q];
  }
  __syncwarp();
  // the 43 columns of a * b
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int yi = s.ys[q][i];
      (i & 1 ? l2[q] : lo[q]) += yi * s.xs[q][32 + lane - i];
      if (i >= 12) (i & 1 ? h2[q] : hi[q]) += yi * s.xs[q][64 + lane - i];
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    lo[q] += l2[q];
    hi[q] += h2[q];
    l2[q] = h2[q] = 0;
  }
  warp_wn43<N, 2>(lo, hi, lane);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < N; ++q) s.ys[q][lane] = lo[q];
  __syncwarp();
  // m = low 21 columns of t * n', lane k < 21 forming limb k
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      (i & 1 ? m2[q] : m[q]) += s.ys[q][i] * w.np[i];
  }
  // two weak rounds of m from the window of its two lower limbs (the
  // carry out of limb 20 lands in lane 21, which nothing reads)
#pragma unroll
  for (int q = 0; q < N; ++q) {
    m[q] += m2[q];
    const int s1 = __shfl_up_sync(FULL_MASK, m[q], 1);
    const int s2 = __shfl_up_sync(FULL_MASK, m[q], 2);
    const int w0 = lane >= 2 ? s2 : 0, w1 = lane >= 1 ? s1 : 0;
    const int v1 = (w1 & MASK) + (w0 >> LB);
    const int v2 = (m[q] & MASK) + (w1 >> LB);
    m[q] = (v2 & MASK) + (v1 >> LB);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < N; ++q) s.ys[q][lane] = m[q];
  __syncwarp();
  // t += m * p, p from registers (0 where the limb does not exist)
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int pr = s.ys[q][i] * w.p[i];
      if (i < 12 || lane >= i)
        (i & 1 ? l2[q] : lo[q]) += pr;
      else
        (i & 1 ? h2[q] : hi[q]) += pr;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    lo[q] += l2[q];
    hi[q] += h2[q];
  }
  warp_wn43<N, 3>(lo, hi, lane);
  // out limb k = column 21 + k: lo of lane k + 21 (k <= 10) or hi of lane
  // k - 11; the low half is exactly 0 or R, so carry one into limb 0 iff
  // any of columns 0..20 is nonzero
  const int src = (lane + NL) & 31;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const unsigned nz = __ballot_sync(FULL_MASK, lane < NL && lo[q] != 0);
    const int fl = __shfl_sync(FULL_MASK, lo[q], src);
    const int fh = __shfl_sync(FULL_MASK, hi[q], src);
    r[q] = lane <= 10 ? fl : (lane < NL ? fh : 0);
    if (lane == 0) r[q] += nz != 0;
  }
  __syncwarp();
}

// out = a^e over T lanes, one warp (block) a lane, e given LSB first as
// nbits 0/1 ints; limb k of lane t of a at a[k*sal + t*sat], of out at
// out[k*sol + t*sot].  consts: the field block (p, n', sub_d, one_mont,
// ...).
__global__ void __launch_bounds__(32)
inv_kernel(const int* __restrict__ a, int* __restrict__ out,
           const int* __restrict__ consts, const int* __restrict__ bits,
           int nbits, i64 sal, i64 sat, i64 sol, i64 sot) {
  __shared__ int C[4 * NL];
  __shared__ int sbits[MAX_BITS];
  __shared__ WarpRows rows;
  for (int i = threadIdx.x; i < nbits; i += blockDim.x) sbits[i] = bits[i];
  for (int i = threadIdx.x; i < 2 * 96; i += blockDim.x)
    rows.xs[i / 96][i % 96] = 0;
  stage_consts(consts, C, 4 * NL);
  const int lane = threadIdx.x;
  const i64 t = blockIdx.x;
  WarpConsts w;
  warp_consts(C, lane, w);
  int acc = lane < NL ? C[C_ONE + lane] : 0;
  int base = lane < NL ? a[lane * sal + t * sat] : 0;
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    const bool mul = sbits[i] == 1, sqr = i + 1 < nbits;
    if (mul && sqr) {
      const int x[2] = {acc, base}, y[2] = {base, base};
      int r[2];
      warp_mont_mul<2>(x, y, r, w, rows, lane);
      acc = r[0];
      base = r[1];
    } else if (mul) {
      warp_mont_mul<1>(&acc, &base, &acc, w, rows, lane);
    } else if (sqr) {
      warp_mont_mul<1>(&base, &base, &base, w, rows, lane);
    }
  }
  if (lane < NL) out[lane * sol + t * sot] = acc;
}

// out (21, T) = a * b^iters (Montgomery products, one after another),
// a, b (21, T) contiguous
__global__ void __launch_bounds__(THREADS)
mont_chain_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  int* __restrict__ out, const int* __restrict__ consts,
                  i64 T, int iters) {
  __shared__ int C[2 * NL];
  stage_consts(consts, C, 2 * NL);
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int x[NL], y[NL], z[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    x[k] = a[k * T + t];
    y[k] = b[k * T + t];
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    mont_mul(x, y, C, z);
#pragma unroll
    for (int k = 0; k < NL; ++k) x[k] = z[k];
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k * T + t] = x[k];
}

extern "C" {

int zk_fold_mul(const int* x, int* out, const int* consts, i64 B, i64 h,
                void* stream) {
  fold_mul_kernel<<<blocks_for(B * h), THREADS, 0, (cudaStream_t)stream>>>(
      x, out, consts, B, h);
  return (int)cudaGetLastError();
}

int zk_inv(const int* a, int* out, const int* consts, const int* bits,
           int nbits, i64 T, i64 sal, i64 sat, i64 sol, i64 sot,
           void* stream) {
  if (nbits > MAX_BITS) return (int)cudaErrorInvalidValue;
  inv_kernel<<<(unsigned)T, 32, 0, (cudaStream_t)stream>>>(
      a, out, consts, bits, nbits, sal, sat, sol, sot);
  return (int)cudaGetLastError();
}

int zk_mont_chain(const int* a, const int* b, int* out, const int* consts,
                  i64 T, int iters, void* stream) {
  mont_chain_kernel<<<blocks_for(T), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, consts, T, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
