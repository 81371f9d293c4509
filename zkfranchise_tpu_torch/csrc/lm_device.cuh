// Device code shared by the kernel sources of this directory: the 21 x 13
// bit limb arithmetic (ops/lm.py), repeated step for step so that every
// limb equals the plain PyTorch version's.  (The point additions are the
// cooperative forms of lm_kernels.cu.)  Each .cu file includes this header
// and is compiled on its own into its own library.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NL 21
#define WIDE 43
#define LB 13
#define MASK 8191
#define THREADS 128

// rows of the 126-int field block (ops/lm.pack_consts) that the kernels
// read: p, n' = -p^-1 mod R, the spread constant sub_d and one (R mod p)
#define C_P 0
#define C_NP 21
#define C_SUBD 42
#define C_ONE 63

typedef long long i64;

// ---------------------------------------------------------------------------
// limb arithmetic (ops/lm.py)
// ---------------------------------------------------------------------------

// t[i] <- (t[i] & MASK) + (t[i-1] >> 13); the carry out of the top limb
// is dropped (lm.weak_norm, one round)
template <int N>
__device__ __forceinline__ void weak_norm(int* t) {
#pragma unroll
  for (int i = N - 1; i > 0; --i) t[i] = (t[i] & MASK) + (t[i - 1] >> LB);
  t[0] = t[0] & MASK;
}

// c[0..42] = column sums of a*b (lm.wide_mul)
__device__ __forceinline__ void wide_mul(const int* a, const int* b, int* c) {
#pragma unroll
  for (int k = 0; k < WIDE; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) c[i + j] += a[i] * b[j];
  }
}

// c[0..20] = low 21 columns of a*b (lm.low_mul)
__device__ __forceinline__ void low_mul(const int* a, const int* b, int* c) {
#pragma unroll
  for (int k = 0; k < NL; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL - i; ++j) c[i + j] += a[i] * b[j];
  }
}

// Karatsuba column sums: one level over an 11 + 10 limb split forms a
// product's 43 column sums from 121 + 100 + 121 = 342 multiply-adds
// instead of the schoolbook's 441 (the low half a0*b0, the high half
// a1*b1, and the middle (a0+a1)(b0+b1) - a0*b0 - a1*b1), for a few more
// registers and adds.  The middle columns may pass 2^31, so they are
// formed modulo 2^32 (unsigned); every true column sum of a*b fits in an
// int, so each column equals the schoolbook's, and so does every limb
// after it.

// limb j of an operand held in an array (registers, shared memory)
struct FromPtr {
  const int* b;
  __device__ __forceinline__ unsigned operator()(int j) const {
    return (unsigned)b[j];
  }
};

// c[0..42] += column sums of a * b (b(j): limb j of the other operand)
template <class Bv>
__device__ __forceinline__ void cols_add(const int* a, Bv b, int* c) {
  unsigned lo[21], mid[21], hi[19], sa[11], sb[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) {
    sa[i] = (unsigned)a[i] + (i < 10 ? (unsigned)a[11 + i] : 0u);
    sb[i] = b(i) + (i < 10 ? b(11 + i) : 0u);
  }
#pragma unroll
  for (int k = 0; k < 21; ++k) lo[k] = mid[k] = 0u;
#pragma unroll
  for (int k = 0; k < 19; ++k) hi[k] = 0u;
#pragma unroll
  for (int i = 0; i < 11; ++i) {
#pragma unroll
    for (int j = 0; j < 11; ++j) {
      lo[i + j] += (unsigned)a[i] * b(j);
      mid[i + j] += sa[i] * sb[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j)
      hi[i + j] += (unsigned)a[11 + i] * b(11 + j);
  }
#pragma unroll
  for (int k = 0; k < 21; ++k) {
    mid[k] -= lo[k] + (k < 19 ? hi[k] : 0u);
    c[k] = (int)((unsigned)c[k] + lo[k]);
  }
#pragma unroll
  for (int k = 0; k < 21; ++k)
    c[11 + k] = (int)((unsigned)c[11 + k] + mid[k]);
#pragma unroll
  for (int k = 0; k < 19; ++k)
    c[22 + k] = (int)((unsigned)c[22 + k] + hi[k]);
}

// The end of mont_reduce, t = weak_norm(t + m*p, 3) given t + m*p: the
// low half is exactly 0 or R, so carry one iff any low limb is nonzero
__device__ __forceinline__ void reduce_tail(int* t, int* out) {
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

// out = cols * R^-1 mod p, limbs <= 2^13 + 2 (lm.mont_reduce); cols is
// clobbered.  pc points at p, then n' = -p^-1 mod R (21 limbs each).
// KARATSUBA forms m*p with cols_add (the same integers, so the same
// limbs) instead of the schoolbook.
template <bool KARATSUBA = false>
__device__ __forceinline__ void mont_reduce(int* t, const int* pc, int* out) {
  weak_norm<WIDE>(t);
  weak_norm<WIDE>(t);
  int m[NL];
  low_mul(t, pc + C_NP, m);
  weak_norm<NL>(m);
  weak_norm<NL>(m);
  if constexpr (KARATSUBA) {
    cols_add(m, FromPtr{pc + C_P}, t);
  } else {
    int mp[WIDE];
    wide_mul(m, pc + C_P, mp);
#pragma unroll
    for (int k = 0; k < WIDE; ++k) t[k] += mp[k];
  }
  reduce_tail(t, out);
}

// the schoolbook Montgomery product: 441 + 231 + 441 = 1,113 multiply-adds
__device__ __forceinline__ void mont_mul(const int* a, const int* b,
                                         const int* pc, int* out) {
  int c[WIDE];
  wide_mul(a, b, c);
  mont_reduce(c, pc, out);
}

// p and n' of a field (the first two rows of ops/lm.pack_consts), passed
// by value: a kernel that takes them as a launch parameter reads its
// product's operands straight from the parameter bank (no staging in
// shared memory, no barrier)
struct FieldPN {
  int c[2 * NL];
};

// the Karatsuba Montgomery product, all in registers: 342 + 231 + 342 =
// 915 multiply-adds, every limb equal to the schoolbook's
__device__ __forceinline__ void mont_mul_karatsuba(const int* a, const int* b,
                                                   const int* pc, int* out) {
  int c[WIDE];
#pragma unroll
  for (int k = 0; k < WIDE; ++k) c[k] = 0;
  cols_add(a, FromPtr{b}, c);
  mont_reduce<true>(c, pc, out);
}

// threadIdx.x, blockIdx.x and blockIdx.y, read afresh at each use: the
// compiler may not merge two of these reads, so indices derived from them
// are recomputed where they are used instead of held in registers across
// a kernel's products (a fold launch stages and stores up to seven times)
__device__ __forceinline__ int tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

__device__ __forceinline__ unsigned ctaid_x() {
  unsigned c;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(c));
  return c;
}

__device__ __forceinline__ int ctaid_y() {
  int c;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(c));
  return c;
}

// out (21, T) = a * b^chain over the lanes [ctaid_x()*tile, (ctaid_x()+1)*
// tile) that a block of THREADS threads owns, a and b (21, T) contiguous,
// T < 2^31: the body of mm2d_kernel and mont_chain_kernel.  x lives in
// registers for the whole chain; b is read again (from L1) for every
// product, its lane recomputed from the block index, so that only x, the
// lane's offset in the block and the chain's count live between products
// (the Karatsuba product takes the 128 registers that four blocks an SM
// allow; y held beside it spilled).
__device__ __forceinline__ void chain_tile(const int* __restrict__ a,
                                           const int* __restrict__ b,
                                           int* __restrict__ out,
                                           const FieldPN& pn, unsigned T,
                                           unsigned tile, int chain) {
#pragma unroll 1
  for (unsigned l = tid(); l < tile; l += THREADS) {
    const unsigned t = ctaid_x() * tile + l;
    if (t >= T) break;
    int x[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) x[k] = a[(i64)k * T + t];
#pragma unroll 1
    for (int i = 0; i < chain; ++i) {
      const int* pb = b + ctaid_x() * tile + l;
      int y[NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) y[k] = pb[(i64)k * T];
      mont_mul_karatsuba(x, y, pn.c, x);
    }
    int* o = out + ctaid_x() * tile + l;
#pragma unroll
    for (int k = 0; k < NL; ++k) o[(i64)k * T] = x[k];
  }
}

// s[0, n) = g[0, n) by every thread of the block (1-D or 2-D), then a
// barrier
__device__ __forceinline__ void stage_consts(const int* g, int* s, int n) {
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n; i += nt)
    s[i] = g[i];
  __syncthreads();
}


static unsigned blocks_for(i64 n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// Grids of the kernels whose block is tx lanes by THREADS / tx rows: the
// blocks that cover T lanes, and the blocks that cover n rows `per` at a
// time, capped at the y / z grid limit (the kernels loop past it)
static unsigned lane_blocks(i64 T, int tx) {
  return (unsigned)((T + tx - 1) / tx);
}

static unsigned grid_cap(i64 n, int per) {
  const i64 b = (n + per - 1) / per;
  return (unsigned)(b < 65535 ? b : 65535);
}
