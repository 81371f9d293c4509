// Hand-written Hopper (sm_90a) kernels for the batch inversion and the
// in-kernel chains over the limb-major BN254 core (layout and device
// functions: lm_device.cuh).
//
// Kernels and the TPU kernels they replace:
//   zk_fold_mul        <- fold_mul (zkfranchise_tpu/ops/pallas/lm_kernels.py
//                         _fold_mul_kernel): out[j] = x[j] * x[j + m/2]
//   zk_fold_mul_levels <- the same fold_mul, several levels of batch_inv's
//                         product tree a launch
//   zk_inv             <- inv (lm_kernels.py _inv_kernel): a^(p-2) by
//                         square-and-multiply, exponent bits shared by all
//                         lanes; inv(0) = 0
//   zk_batch_inv_top,  <- batch_inv (lm_kernels.py batch_inv, which chains
//   zk_batch_inv_down     fold_mul, inv and mont_mul): the top of the tree
//                         with the Fermat chain at its root, and the walk
//                         down
//   zk_mont_chain      <- pallas_chain (scripts/micro_montmul.py
//                         chain_kernel): x = a, then `iters` times x = x * b
// (zk_scalar_mul, the double-and-add, runs on the cooperative add in
// lm_kernels.cu.)
//
// Design of fold_mul: one thread per lane, limbs in registers, the
// schoolbook product of the plain PyTorch version: bound by integer
// multiply-adds (1,113 a product against 252 bytes of traffic).
//
// Design of mont_chain: the body of mm2d (lm_device.cuh chain_tile), one
// lane a thread, so 131,072 lanes are 1,024 blocks on the 528 slots of
// four blocks an SM.  A chain issues nothing but its products, so the
// integer multiply-add pipe bounds it: the Karatsuba register product (915
// multiply-adds against the schoolbook's 1,113), p and n' by value in the
// launch's parameters, x in registers, b read again from L1 for each
// product.
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
// Design of batch_inv over (B, 21, X), X = 2^n: the tree of
// lm.batch_inv_lanes, pair for pair (v_0 = d; up, v_l[j] = v_{l-1}[j] *
// v_{l-1}[j + h_l], h_l = X >> l; the root inverted; down, u_{l-1}[j] =
// u_l[j] * v_{l-1}[j + h_l] and u_{l-1}[j + h_l] = u_l[j] * v_{l-1}[j]).
// Column sums are exact integers whatever the method and the operand
// order, so the Karatsuba products give every limb of the schoolbook ones.
// It is about 3X products a row and one Fermat chain of 363 products a
// row: bound by integer multiply-adds where the tree is wide and by the
// chain's latency at its root.  The composite it replaces ran a launch a
// level up and two a level down, and a copy a level (torch.cat): 3n + 1
// launches and n copies.  Here, at most five levels a launch:
//   - v_l[j] is the product of d[j + i * h_l], i < 2^l.  So a block that
//     owns `cols` columns [c, c + cols) of level L computes levels L0+1 ..
//     L of those columns alone: it reads 2^(L-L0) strips of `cols`
//     consecutive lanes of v_{L0} (coalesced), and keeps each level's
//     strips in shared memory, folded in place (zk_fold_mul_levels:
//     fold_mul's counterpart at several levels).  The walk down is the same
//     tiles in reverse (zk_batch_inv_down), two products an item, the
//     second re-reading its u from shared memory after the first has
//     stored its result beside it.
//   - A level of a block has half the items of the one below it, so the
//     top levels of a launch leave threads idle.  cols is 64 where a launch
//     takes at most four levels and its top level is that wide (the
//     narrowest level then has an item for half of the 128 threads; 43 KB
//     of strips, four blocks an SM), else 32; the kernels are compiled for
//     both.
//   - Going down, each thread copies its next item's v (cp.async) into two
//     stage slots while its product runs (21 KB a block): the walk down
//     reads a v a product from device memory, and without the copy the
//     blocks wait for their loads in step.  Going up only the first level
//     reads device memory; the same copy there spilled and read slower.
//   - The top of the tree, the levels of width <= 32, runs in one launch a
//     block a row (zk_batch_inv_top): the narrow levels as one-thread
//     products in shared memory, and the chain on one warp, inv_kernel's
//     own loop (warp_pow).  At X <= 32 it is the whole call.
//   - One (B, 21, X) buffer, the output, holds every level: v_l (1 <= l)
//     at lanes [h_l, 2 h_l) on the way up, u_l at lanes [0, h_l) on the
//     way down; so no copy and no concatenation, and the result is u_0 at
//     lanes [0, X).  Every lane that the block owning columns [c, c +
//     cols) of a launch's top level L reads or writes lies at c + i * (X >>
//     L) + [0, cols) for some i: the blocks of a launch touch disjoint
//     lanes, and a down launch's writes over v_l (l > L0) and u_L follow a
//     barrier after their last read.
// The plan (levels a launch, columns, grid, shared memory) is ops/cuda/
// lm_kernels.py batch_inv_plan, and only there: each launch takes its
// columns and shared bytes as arguments, which the entry points check
// against what the kernels index and launch as given.
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

// base^e for the element held as limb k at lane k of the warp (0 past limb
// 20), e the nbits exponent bits staged in sbits (LSB first): acc starts at
// one (R mod p), acc *= base where a bit is set, base *= base, as
// lm.pow_bits; the product a zero bit would discard and the last square are
// not computed
__device__ __forceinline__ int warp_pow(int base, const int* C,
                                        const int* sbits, int nbits,
                                        const WarpConsts& w, WarpRows& rows,
                                        int lane) {
  int acc = lane < NL ? C[C_ONE + lane] : 0;
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
  return acc;
}

// The warp's shared state for warp_pow: the exponent bits, the zero pads of
// its rows and the field block (p, n', sub_d, one), then a barrier
__device__ __forceinline__ void warp_pow_stage(const int* consts,
                                               const int* bits, int nbits,
                                               int* C, int* sbits,
                                               WarpRows& rows) {
  for (int i = threadIdx.x; i < nbits; i += blockDim.x) sbits[i] = bits[i];
  for (int i = threadIdx.x; i < 2 * 96; i += blockDim.x)
    rows.xs[i / 96][i % 96] = 0;
  stage_consts(consts, C, 4 * NL);
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
  warp_pow_stage(consts, bits, nbits, C, sbits, rows);
  const int lane = threadIdx.x;
  const i64 t = blockIdx.x;
  WarpConsts w;
  warp_consts(C, lane, w);
  const int base = lane < NL ? a[lane * sal + t * sat] : 0;
  const int acc = warp_pow(base, C, sbits, nbits, w, rows, lane);
  if (lane < NL) out[lane * sol + t * sot] = acc;
}

// ---------------------------------------------------------------------------
// batch_inv: the tile launches up and down, and the top of the tree
// ---------------------------------------------------------------------------

#define INV_COLS 32     // columns of a tile launch's top level a block owns,
                        // at least (a warp's coalesced row)
#define INV_LEVELS 5    // levels a tile launch takes at most
#define INV_TOP 32      // widest level the top kernel takes (2^INV_LEVELS)
#define INV_THREADS 128  // threads of a tile launch's block

// strip m of a block's level in shared memory (cols = 1 << lc columns):
// limb q of column t at [q * cols + t]
__device__ __forceinline__ int* strip(int* s, int m, int lc) {
  return s + ((m * NL) << lc);
}

// cp.async: 4 bytes from device to shared memory without a register; the
// thread waits for its own copies (cp_async_wait<N>: all but the N groups
// committed last)
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The thread's stage slot `slot` in shared memory, after the block's
// 2^(k-1) strips: limb q at [q * INV_THREADS], NL ints a thread
__device__ __forceinline__ int* stage(int* s, int k, int lc, int slot) {
  return s + ((((1 << (k - 1)) * NL) << lc)) + slot * NL * INV_THREADS +
         tid();
}

// cp.async of the 21 limbs at p (limb stride X) into the thread's slot
__device__ __forceinline__ void fetch(int* st, const int* p, unsigned X) {
#pragma unroll
  for (int q = 0; q < NL; ++q) cp_async4(st + q * INV_THREADS, p + q * X);
}

// x[0..20] = the thread's slot, every limb in its register before what
// follows issues (the xor reads them all; the asm that takes it is ordered
// before the next asm, a cp.async that may refill the slot)
__device__ __forceinline__ void take(const int* st, int* x) {
  int z = 0;
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    x[q] = st[q * INV_THREADS];
    z ^= x[q];
  }
  asm volatile("" ::"r"(z));
}

// item `it` of a level of a block (strip it >> lc, column it & (cols - 1)
// of a block owning cols = 1 << lc columns of a top level hk lanes wide):
// its lane of level l in row ctaid_y(), in d for level 0, else at heap
// lanes [X >> l, 2 (X >> l))
__device__ __forceinline__ const int* level_at(const int* d, const int* heap,
                                               unsigned X, int l,
                                               unsigned hk, int lc, int it) {
  return (l == 0 ? d : heap + (X >> l)) + ctaid_y() * NL * X +
         (ctaid_x() << lc) + (it >> lc) * hk + (it & ((1 << lc) - 1));
}

// Levels L0+1 .. L0+k of the product tree into heap (v_l at lanes [X >> l,
// 2 (X >> l)) of each row), from v_{L0} (d at L0 = 0, else heap).  Block
// (i, b) owns columns [i * cols, (i + 1) * cols) of level L0+k in row b
// (cols = 1 << lc); level L0+1 is read from device memory, the levels
// above from the block's strips in shared memory (2^(k-1) strips, folded
// in place: item (m, t) alone reads strips m and m + S at column t and
// writes strip m).  Indices are recomputed from tid() / ctaid after each
// product, so that only the loop's state lives beside it.
template <int lc>
__global__ void __launch_bounds__(INV_THREADS, 4)
fold_mul_levels_kernel(const int* d, int* heap, const FieldPN pn, unsigned X,
                       int L0, int k) {
  extern __shared__ int s[];
  const unsigned hk = X >> (L0 + k);
  int S = 1 << (k - 1);
#pragma unroll 1
  for (int it = tid(); it < S << lc; it += INV_THREADS) {
    const int* in = level_at(d, heap, X, L0, hk, lc, it);
    const unsigned h = X >> (L0 + 1);
    int x[NL], y[NL];
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      x[q] = in[q * X];
      y[q] = in[q * X + h];
    }
    mont_mul_karatsuba(x, y, pn.c, x);
    const int t = it & ((1 << lc) - 1);
    int* sm = strip(s, it >> lc, lc) + t;
    int* o = heap + ctaid_y() * NL * X + (X >> (L0 + 1)) + (ctaid_x() << lc) +
             (it >> lc) * hk + t;
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      sm[q << lc] = x[q];
      o[q * X] = x[q];
    }
  }
#pragma unroll 1
  for (int i = 2; i <= k; ++i) {
    __syncthreads();
    S >>= 1;
#pragma unroll 1
    for (int it = tid(); it < S << lc; it += INV_THREADS) {
      const int* sx = strip(s, it >> lc, lc) + (it & ((1 << lc) - 1));
      int x[NL], y[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        x[q] = sx[q << lc];
        y[q] = sx[((S * NL) << lc) + (q << lc)];
      }
      mont_mul_karatsuba(x, y, pn.c, x);
      const int t = it & ((1 << lc) - 1);
      int* sm = strip(s, it >> lc, lc) + t;
      int* o = heap + ctaid_y() * NL * X + (X >> (L0 + i)) +
               (ctaid_x() << lc) + (it >> lc) * hk + t;
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        sm[q << lc] = x[q];
        o[q * X] = x[q];
      }
    }
  }
}

// The item after (i, it) of the walk down that this thread owns: the next
// of level i (S strips of u), else the first of the levels below that has
// one for it; i becomes 0 when there is none
__device__ __forceinline__ void next_item(int& i, int& it, int& S, int lc) {
  it += INV_THREADS;
  while (i >= 1 && it >= S << lc) {
    --i;
    S <<= 1;
    it = tid();
  }
}

// The walk down from u_{L0+k} (heap lanes [0, X >> (L0+k))) to u_{L0}
// (heap lanes [0, X >> L0)), v_l read from heap (d for v_0).  Block (i, b)
// owns the same columns as in the walk up; u_{L0+k}'s strip is staged in
// shared memory and each level below is kept there, in place, but the last,
// which goes to device memory.  An item (m, t) forms both children of u
// strip m at column t: first u * v_l strip m into strip m + S (unused at
// this level), then u, read again, * v_l strip m + S into strip m.  Each
// product's v comes through a stage slot (0 for the first product, 1 for
// the second), refilled with the next item's v (cp.async) as soon as it
// is taken, so that the copy runs under the product; v does not depend on
// the levels in shared memory, so the next item may lie a level below.
template <int lc>
__global__ void __launch_bounds__(INV_THREADS, 4)
batch_inv_down_kernel(const int* d, int* heap, const FieldPN pn, unsigned X,
                      int L0, int k) {
  extern __shared__ int s[];
  const unsigned hk = X >> (L0 + k);
  for (int e = tid(); e < NL << lc; e += INV_THREADS)
    s[e] = heap[ctaid_y() * NL * X + (e >> lc) * X + (ctaid_x() << lc) +
                (e & ((1 << lc) - 1))];
  {
    int i = k, it = tid() - INV_THREADS, S = 1;
    next_item(i, it, S, lc);
    if (i >= 1) {
      const int* p = level_at(d, heap, X, L0 + i - 1, hk, lc, it);
      fetch(stage(s, k, lc, 0), p, X);
      cp_async_commit();
      fetch(stage(s, k, lc, 1), p + (X >> (L0 + i)), X);
    } else {
      cp_async_commit();
    }
    cp_async_commit();
  }
  int S = 1;
#pragma unroll 1
  for (int i = k; i >= 1; --i) {
    __syncthreads();
#pragma unroll 1
    for (int it = tid(); it < S << lc; it += INV_THREADS) {
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        int x[NL], y[NL];
        cp_async_wait<1>();
        take(stage(s, k, lc, half), y);
        {
          int ni = i, nit = it, nS = S;
          next_item(ni, nit, nS, lc);
          if (ni >= 1)
            fetch(stage(s, k, lc, half),
                  level_at(d, heap, X, L0 + ni - 1, hk, lc, nit) +
                      (half ? X >> (L0 + ni) : 0u),
                  X);
          cp_async_commit();
        }
        const int* su = strip(s, it >> lc, lc) + (it & ((1 << lc) - 1));
#pragma unroll
        for (int q = 0; q < NL; ++q) x[q] = su[q << lc];
        mont_mul_karatsuba(x, y, pn.c, x);
        const int m = (it >> lc) + (half ? 0 : S);
        const int t = it & ((1 << lc) - 1);
        if (i == 1) {
          int* o = heap + ctaid_y() * NL * X + (ctaid_x() << lc) + m * hk + t;
#pragma unroll
          for (int q = 0; q < NL; ++q) o[q * X] = x[q];
        } else {
          int* sm = strip(s, m, lc) + t;
#pragma unroll
          for (int q = 0; q < NL; ++q) sm[q << lc] = x[q];
        }
      }
    }
    S <<= 1;
  }
}

// The top of the tree, one block (a warp) a row: v_{t0} of w = X >> t0 <=
// INV_TOP lanes (d at t0 = 0, else heap lanes [w, 2w)) up to the root,
// the root's inverse by Fermat (warp_pow, as inv_kernel), and the walk down
// to u_{t0}, written to heap lanes [0, w).  The levels live in shared
// memory in heap order, level t0 + r at [w >> r, 2 (w >> r)); a level's
// products are one a thread (the Karatsuba register product).
__global__ void __launch_bounds__(32)
batch_inv_top_kernel(const int* d, int* heap, const int* __restrict__ consts,
                     const int* __restrict__ bits, int nbits, unsigned X,
                     int t0) {
  __shared__ int C[4 * NL];
  __shared__ int sbits[MAX_BITS];
  __shared__ WarpRows rows;
  __shared__ int v[NL][2 * INV_TOP];
  warp_pow_stage(consts, bits, nbits, C, sbits, rows);
  const int lane = threadIdx.x;
  const unsigned row = blockIdx.x * NL * X, w = X >> t0;
  const int lw = __ffs(w) - 1;
  const int* src = t0 == 0 ? d + row : heap + row + w;
  for (int e = lane; e < NL << lw; e += 32)
    v[e >> lw][w + (e & (w - 1))] = src[(e >> lw) * X + (e & (w - 1))];
  __syncwarp();
  // up: the level at [h, 2h) from the one at [2h, 4h)
#pragma unroll 1
  for (unsigned h = w / 2; h >= 1; h /= 2) {
    if (lane < h) {
      int x[NL], y[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        x[q] = v[q][2 * h + lane];
        y[q] = v[q][3 * h + lane];
      }
      mont_mul_karatsuba(x, y, C, x);
#pragma unroll
      for (int q = 0; q < NL; ++q) v[q][h + lane] = x[q];
    }
    __syncwarp();
  }
  // the root, at [1, 2)
  {
    WarpConsts wc;
    warp_consts(C, lane, wc);
    const int r = warp_pow(lane < NL ? v[lane][1] : 0, C, sbits, nbits, wc,
                           rows, lane);
    __syncwarp();
    if (lane < NL) v[lane][1] = r;
    __syncwarp();
  }
  // down: u at [h, 2h) -> the level at [2h, 4h) over v's lanes there; lane
  // p < h forms u[p] * v[p + h] into [2h + p], lane h + p u[p] * v[p] into
  // [3h + p]; every operand is read before any product is stored
#pragma unroll 1
  for (unsigned h = 1; h < w; h *= 2) {
    const bool on = lane < 2 * h;
    int x[NL];
    if (on) {
      const unsigned p = lane & (h - 1);
      const unsigned vl = lane < h ? 3 * h + p : 2 * h + p;
      int y[NL];
#pragma unroll
      for (int q = 0; q < NL; ++q) {
        x[q] = v[q][h + p];
        y[q] = v[q][vl];
      }
      mont_mul_karatsuba(x, y, C, x);
    }
    __syncwarp();
    if (on) {
#pragma unroll
      for (int q = 0; q < NL; ++q) v[q][2 * h + lane] = x[q];
    }
    __syncwarp();
  }
  for (int e = lane; e < NL << lw; e += 32)
    heap[row + (e >> lw) * X + (e & (w - 1))] = v[e >> lw][w + (e & (w - 1))];
}

// out (21, T) = a * b^iters (Montgomery products, one after another), a
// and b (21, T) contiguous, T < 2^31, one lane a thread (chain_tile)
__global__ void __launch_bounds__(THREADS, 4)
mont_chain_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  int* __restrict__ out, const FieldPN pn, unsigned T,
                  int iters) {
  chain_tile(a, b, out, pn, T, THREADS, iters);
}

// rows of X lanes, B of them, that one batch_inv launch may take: X a
// power of two, B on the grid's y axis, every index 32-bit
static bool inv_rows_ok(i64 B, i64 X) {
  return X >= 1 && (X & (X - 1)) == 0 && B >= 1 && B <= 65535 &&
         B * NL * X < ((i64)1 << 31);
}

static FieldPN field_pn(const int* pn) {
  FieldPN f;
  for (int q = 0; q < 2 * NL; ++q) f.c[q] = pn[q];
  return f;
}

// a tile launch of kernel<5> or kernel<6> as the plan gives it (cols = 32
// or 64 columns of its top level L0 + k a block, smem bytes of shared
// memory a block): checked here, not chosen; refused unless it is a launch
// the kernels take (1..INV_LEVELS levels, a top level of at least cols
// lanes) and smem holds the 2^(k-1) strips and, going down, the stage slots
// that the kernel indexes
template <class Kernel>
static int inv_tile_launch(Kernel k5, Kernel k6, bool down, const int* d,
                           int* heap, const int* pn, i64 B, i64 X, int L0,
                           int k, int cols, int smem, void* stream) {
  const int lc = cols == 64 ? 6 : 5;
  if (!inv_rows_ok(B, X) || (cols != 32 && cols != 64) || k < 1 ||
      k > INV_LEVELS || L0 < 0 || L0 + k > 30 || (X >> (L0 + k)) < cols ||
      (i64)smem < (((i64)NL << (k - 1 + lc)) +
                   (down ? 2 * NL * INV_THREADS : 0)) * (i64)sizeof(int))
    return (int)cudaErrorInvalidValue;
  const Kernel kern = lc == 6 ? k6 : k5;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((X >> (L0 + k)) >> lc), (unsigned)B);
  kern<<<grid, INV_THREADS, smem, (cudaStream_t)stream>>>(
      d, heap, field_pn(pn), (unsigned)X, L0, k);
  return (int)cudaGetLastError();
}

extern "C" {

int zk_fold_mul(const int* x, int* out, const int* consts, i64 B, i64 h,
                void* stream) {
  fold_mul_kernel<<<blocks_for(B * h), THREADS, 0, (cudaStream_t)stream>>>(
      x, out, consts, B, h);
  return (int)cudaGetLastError();
}

// pn: p and n' of the field (42 ints) in HOST memory; cols and smem: the
// plan's (lm_kernels.py batch_inv_plan)
int zk_fold_mul_levels(const int* d, int* heap, const int* pn, i64 B, i64 X,
                       int L0, int k, int cols, int smem, void* stream) {
  return inv_tile_launch(fold_mul_levels_kernel<5>, fold_mul_levels_kernel<6>,
                         false, d, heap, pn, B, X, L0, k, cols, smem, stream);
}

int zk_batch_inv_down(const int* d, int* heap, const int* pn, i64 B, i64 X,
                      int L0, int k, int cols, int smem, void* stream) {
  return inv_tile_launch(batch_inv_down_kernel<5>, batch_inv_down_kernel<6>,
                         true, d, heap, pn, B, X, L0, k, cols, smem, stream);
}

// smem: the plan's shared bytes a block, refused unless they are the
// kernel's static shared memory
int zk_batch_inv_top(const int* d, int* heap, const int* consts,
                     const int* bits, int nbits, i64 B, i64 X, int t0,
                     int smem, void* stream) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, batch_inv_top_kernel);
  if (rc != cudaSuccess) return (int)rc;
  if (!inv_rows_ok(B, X) || nbits > MAX_BITS || t0 < 0 || t0 > 30 ||
      (X >> t0) < 1 || (X >> t0) > INV_TOP ||
      (size_t)smem != attr.sharedSizeBytes)
    return (int)cudaErrorInvalidValue;
  batch_inv_top_kernel<<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
      d, heap, consts, bits, nbits, (unsigned)X, t0);
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

// pn: p and n' of the field (42 ints) in HOST memory
int zk_mont_chain(const int* a, const int* b, int* out, const int* pn, i64 T,
                  int iters, void* stream) {
  if (iters < 0 || T < 1 || T >= ((i64)1 << 31))
    return (int)cudaErrorInvalidValue;
  mont_chain_kernel<<<blocks_for(T), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, field_pn(pn), (unsigned)T, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
