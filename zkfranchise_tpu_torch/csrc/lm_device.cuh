// Device code shared by the kernel sources of this directory: the 21 x 13
// bit limb arithmetic (ops/lm.py) and the RCB15 point additions
// (ops/ec_lm.py), repeated step for step so that every limb equals the
// plain PyTorch version's.  Each .cu file includes this header and is
// compiled on its own into its own library.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NL 21
#define WIDE 43
#define LB 13
#define MASK 8191
#define THREADS 128

// rows of the 189-int EC constants block (ops/ec_lm.pack_ec_consts); the
// first six are also the 126-int field block (ops/lm.pack_consts)
#define C_P 0
#define C_NP 21
#define C_SUBD 42
#define C_ONE 63
#define C_SUBD2 105
#define C_B3G1 126
#define C_B3G2 147
#define EC_CONSTS 189

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

// acc += weak_norm(weak_norm(wide(a, b))): one lazy term of a sum that is
// reduced once
__device__ __forceinline__ void add_wide_wn2(const int* a, const int* b,
                                             int* acc) {
  int c[WIDE];
  wide_mul(a, b, c);
  weak_norm<WIDE>(c);
  weak_norm<WIDE>(c);
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] += c[k];
}

// Out-of-line forms for the EC kernels.  Inlining a whole G2 add (about
// 40,000 multiply-adds) makes one function too large for ptxas to
// allocate registers in reasonable time; each helper below is compiled
// once and keeps its own limbs in registers, and only the call arguments
// pass through local memory.
__device__ __noinline__ void ec_reduce(int* t, const int* pc, int* out) {
  mont_reduce(t, pc, out);
}

__device__ __noinline__ void ec_mont_mul(const int* a, const int* b,
                                         const int* pc, int* out) {
  mont_mul(a, b, pc, out);
}

__device__ __noinline__ void ec_add_wide(const int* a, const int* b,
                                         int* acc) {
  add_wide_wn2(a, b, acc);
}

// out = weak_norm(D2 - v) over one Fq component (ec_lm n2 / nb1)
__device__ __forceinline__ void neg_d2(const int* v, const int* C, int* out) {
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k] = C[C_SUBD2 + k] - v[k];
  weak_norm<NL>(out);
}

// ---------------------------------------------------------------------------
// Fq / Fq2 steps of RCB15 (ops/ec_lm.py), K = 1 (Fq) or 2 (Fq2 stacked)
// ---------------------------------------------------------------------------

// out = weak_norm(a + b) over K*21 limbs
template <int K>
__device__ __forceinline__ void add_n(const int* a, const int* b, int* out) {
#pragma unroll
  for (int k = 0; k < K * NL; ++k) out[k] = a[k] + b[k];
  weak_norm<K * NL>(out);
}

// out = weak_norm(a + (D - b)), D = sub_d per component (_fq_sub_n,
// _fq2_sub_n)
template <int K>
__device__ __forceinline__ void sub_n(const int* a, const int* b,
                                      const int* C, int* out) {
#pragma unroll
  for (int k = 0; k < K * NL; ++k) out[k] = a[k] + (C[C_SUBD + k % NL] - b[k]);
  weak_norm<K * NL>(out);
}

// Fq product (K = 1) or lazy Fq2 product (K = 2, _mul_stack_fq2):
//   re = reduce(a0*b0 + a1*(D2 - b1)),  im = reduce(a0*b1 + a1*b0)
template <int K>
__device__ __forceinline__ void fmul(const int* a, const int* b,
                                     const int* C, int* out) {
  if constexpr (K == 1) {
    ec_mont_mul(a, b, C, out);
  } else {
    int nb1[NL];
    neg_d2(b + NL, C, nb1);
    int acc[WIDE];
#pragma unroll
    for (int k = 0; k < WIDE; ++k) acc[k] = 0;
    ec_add_wide(a, b, acc);
    ec_add_wide(a + NL, nb1, acc);
    ec_reduce(acc, C, out);
#pragma unroll
    for (int k = 0; k < WIDE; ++k) acc[k] = 0;
    ec_add_wide(a, b + NL, acc);
    ec_add_wide(a + NL, b, acc);
    ec_reduce(acc, C, out + NL);
  }
}

// Round 3 over Fq (_round3_fq): x3 = t3*t1 - t4*y3b, y3 = y3b*x3 + t1*z3,
// z3 = z3*t4 + x3*t3, each as two wide products and one reduction
__device__ __forceinline__ void round3_fq(const int* t3, const int* t4,
                                          const int* y3b, const int* t1,
                                          const int* z3, const int* x3,
                                          const int* C, int* X, int* Y,
                                          int* Z) {
  int ny3b[NL];
  neg_d2(y3b, C, ny3b);
  int acc[WIDE];
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
  ec_add_wide(t3, t1, acc);
  ec_add_wide(t4, ny3b, acc);
  ec_reduce(acc, C, X);
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
  ec_add_wide(y3b, x3, acc);
  ec_add_wide(t1, z3, acc);
  ec_reduce(acc, C, Y);
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
  ec_add_wide(z3, t4, acc);
  ec_add_wide(x3, t3, acc);
  ec_reduce(acc, C, Z);
}

// One Fq2 output of round 3 (_round3_fq2): A*B - C*D (minus) or A*B + C*D
__device__ __forceinline__ void r3_fq2_term(const int* A, const int* B,
                                            const int* Cc, const int* D,
                                            bool minus, const int* C,
                                            int* out) {
  int n[NL];
  int acc[WIDE];
  // re: (a0b0 - a1b1) +- (c0d0 - c1d1)
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
  ec_add_wide(A, B, acc);
  neg_d2(B + NL, C, n);
  ec_add_wide(A + NL, n, acc);
  if (minus) {
    neg_d2(D, C, n);
    ec_add_wide(Cc, n, acc);
    ec_add_wide(Cc + NL, D + NL, acc);
  } else {
    ec_add_wide(Cc, D, acc);
    neg_d2(D + NL, C, n);
    ec_add_wide(Cc + NL, n, acc);
  }
  ec_reduce(acc, C, out);
  // im: (a0b1 + a1b0) +- (c0d1 + c1d0)
#pragma unroll
  for (int k = 0; k < WIDE; ++k) acc[k] = 0;
  ec_add_wide(A, B + NL, acc);
  ec_add_wide(A + NL, B, acc);
  if (minus) {
    neg_d2(D + NL, C, n);
    ec_add_wide(Cc, n, acc);
    neg_d2(D, C, n);
    ec_add_wide(Cc + NL, n, acc);
  } else {
    ec_add_wide(Cc, D + NL, acc);
    ec_add_wide(Cc + NL, D, acc);
  }
  ec_reduce(acc, C, out + NL);
}

template <int K>
__device__ __forceinline__ void round3(const int* t3, const int* t4,
                                       const int* y3b, const int* t1,
                                       const int* z3, const int* x3,
                                       const int* C, int* X, int* Y, int* Z) {
  if constexpr (K == 1) {
    round3_fq(t3, t4, y3b, t1, z3, x3, C, X, Y, Z);
  } else {
    r3_fq2_term(t3, t1, t4, y3b, true, C, X);
    r3_fq2_term(y3b, x3, t1, z3, false, C, Y);
    r3_fq2_term(z3, t4, x3, t3, false, C, Z);
  }
}

// RCB15 Algorithm 7 (a = 0), projective + projective (ec_lm._padd).
// P and Q point at coordinate 0 of a point: coordinate c, limb k at
// [(c*K*21 + k) * rs]; O likewise with stride ors.
template <int K>
__device__ __forceinline__ void padd_point(const int* P, i64 prs,
                                           const int* Q, i64 qrs, int* O,
                                           i64 ors, const int* C) {
  constexpr int W = K * NL;
  int t0[W], t1[W], t2[W], pa[W], pb[W], pc[W];
  {
    int u[W], v[W], s[W], r[W];
    // round 1: X1X2, Y1Y2, Z1Z2 and the three cross sums
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        u[k] = P[(c * W + k) * prs];
        v[k] = Q[(c * W + k) * qrs];
      }
      fmul<K>(u, v, C, c == 0 ? t0 : (c == 1 ? t1 : t2));
    }
    // (x1 + y1)(x2 + y2)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      s[k] = P[k * prs] + P[(W + k) * prs];
      r[k] = Q[k * qrs] + Q[(W + k) * qrs];
    }
    weak_norm<W>(s);
    weak_norm<W>(r);
    fmul<K>(s, r, C, pa);
    // (y1 + z1)(y2 + z2)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      s[k] = P[(W + k) * prs] + P[(2 * W + k) * prs];
      r[k] = Q[(W + k) * qrs] + Q[(2 * W + k) * qrs];
    }
    weak_norm<W>(s);
    weak_norm<W>(r);
    fmul<K>(s, r, C, pb);
    // (x1 + z1)(x2 + z2)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      s[k] = P[k * prs] + P[(2 * W + k) * prs];
      r[k] = Q[k * qrs] + Q[(2 * W + k) * qrs];
    }
    weak_norm<W>(s);
    weak_norm<W>(r);
    fmul<K>(s, r, C, pc);
  }
  int t3[W], t4[W], y3[W], x3[W], tmp[W];
  add_n<K>(t0, t1, tmp);
  sub_n<K>(pa, tmp, C, t3);
  add_n<K>(t1, t2, tmp);
  sub_n<K>(pb, tmp, C, t4);
  add_n<K>(t0, t2, tmp);
  sub_n<K>(pc, tmp, C, y3);
#pragma unroll
  for (int k = 0; k < W; ++k) x3[k] = t0[k] + t0[k] + t0[k];
  weak_norm<W>(x3);
  // round 2: the two b3 scalings
  const int* b3 = C + (K == 1 ? C_B3G1 : C_B3G2);
  int t2b[W], y3b[W], z3[W];
  fmul<K>(t2, b3, C, t2b);
  fmul<K>(y3, b3, C, y3b);
  add_n<K>(t1, t2b, z3);
  sub_n<K>(t1, t2b, C, tmp);  // tmp = new t1
  // round 3
  int X[W], Y[W], Z[W];
  round3<K>(t3, t4, y3b, tmp, z3, x3, C, X, Y, Z);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    O[k * ors] = X[k];
    O[(W + k) * ors] = Y[k];
    O[(2 * W + k) * ors] = Z[k];
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
