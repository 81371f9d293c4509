// Hand-written Hopper (sm_90a) kernels of the layout experiments over the
// limb-major BN254 core (layout and device functions: lm_device.cuh).
//
// Kernels and the TPU kernels they replace:
//   zk_mm2d           <- mm2d (scripts/layout_expt.py): `chain` Montgomery
//                        products x <- x*b on a flat (21, T) lane axis
//   zk_mm3d           <- mm3d (scripts/layout_expt.py): one product on
//                        (B, 21, T), a block owning a (blk, tile) patch of
//                        the (batch, lane) plane
//   zk_add_one        <- pallas_id (scripts/layout_expt2.py): o = a + 1,
//                        the launch-and-copy floor of this binding; 16-byte
//                        int4 loads and stores
//   zk_fused_upsweep  <- fused_upsweep (scripts/layout_expt2.py, its
//                        mono_kernel): every level of a halving int32 sum
//                        tree in ONE launch; the output row is the
//                        concatenation of the levels of width m/2 ... 1
//
// What the experiments vary on the TPU is how many lanes one grid step
// owns and how the lane axis is laid out.  Here `tile` is the number of
// lanes one BLOCK owns: a block has a fixed number of threads (THREADS for
// the arithmetic kernels, COPY_THREADS for the two int32 controls) and each
// thread walks tile / threads lanes, neighbouring threads on neighbouring
// lanes (every limb-row access coalesced).  A small tile gives many blocks
// of little work each, a large one few blocks of long loops: a tile of
// 32,768 lanes over 2^20 lanes is 32 blocks on 132 SMs.  The blocks cover
// the lane axis by ceiling division and mask the ragged edge, so any
// positive tile is legal.  None of the kernels divides: the block indices
// carry the (batch, tile) coordinates that zk_mont_mul and zk_fold_mul
// recover from a flat index with 64-bit divisions.
//
// (The experiments' fold2d, zk_fold2d, runs on the cooperative add and so
// lives in lm_kernels.cu.)
//
// What bounds them on an H100: mm2d and mm3d are bound by integer
// multiply-adds; add_one and fused_upsweep by bytes.  mm2d forms its
// products with the Karatsuba register product of lm_device.cuh (915
// multiply-adds a product against the schoolbook's 1,113: a chain of
// products issues nothing else worth counting, so fewer multiply-adds is
// the only gain left), p and n' by value in the launch's parameters (no
// staging, no barrier) and at most 128 registers so that four blocks fit
// an SM; mm3d keeps the schoolbook product and its staged constants.
// add_one moves 16 bytes per access: each row's part of a block's lanes
// is a scalar head up to the first 16-byte boundary, a body of int4s and
// a scalar tail (any T and tile stay legal), a thread puts COPY_UNROLL
// int4 loads in flight before its stores, and the indices are 32-bit when
// R*T < 2^31.  What is left against a flat copy is the tile itself: a
// block streams 21 separate runs of `tile` lanes, one per row, and with
// 8,192 lanes a block there are only 128 blocks for 132 SMs.
// fused_upsweep gives one block to each row: level 1 is read straight
// from device memory (a 65,536-lane int32 row is 256 KB, more than a
// block's 227 KB of shared memory), its 128 KB result is kept in dynamic
// shared memory, and the remaining levels fold it in place there with one
// __syncthreads() per level, each level also written out.  63 rows are 63
// blocks, so fewer than half the SMs pull on device memory: the price of
// one launch.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

#define COPY_THREADS 256
// int4s in flight per thread in add_one
#define COPY_UNROLL 8
#define UPSWEEP_THREADS 1024
// widest level kept in shared memory: 32,768 ints = 128 KB
#define UPSWEEP_SMEM_INTS 32768
#define MAX_GRID_Y 65535

static unsigned tiles_for(i64 n, i64 tile) {
  return (unsigned)((n + tile - 1) / tile);
}

// out (21, T) = a * b^chain, a and b (21, T) contiguous, T < 2^31; block i
// owns lanes [i*tile, (i+1)*tile), tile <= T (lm_device.cuh chain_tile,
// the body zk_mont_chain runs with one lane a thread)
__global__ void __launch_bounds__(THREADS, 4)
mm2d_kernel(const int* __restrict__ a, const int* __restrict__ b,
            int* __restrict__ out, const FieldPN pn, unsigned T,
            unsigned tile, int chain) {
  chain_tile(a, b, out, pn, T, tile, chain);
}

// out (B, 21, T) = a * b, all three contiguous; block (i, j) owns batch
// rows [j*blk, (j+1)*blk) and lanes [i*tile, (i+1)*tile).  Lane stride 1,
// limb stride T, batch stride 21*T: no stride arguments, no division.
__global__ void __launch_bounds__(THREADS)
mm3d_kernel(const int* __restrict__ a, const int* __restrict__ b,
            int* __restrict__ out, const int* __restrict__ consts, i64 B,
            i64 T, i64 tile, i64 blk) {
  __shared__ int C[2 * NL];
  stage_consts(consts, C, 2 * NL);
  const i64 lane0 = (i64)blockIdx.x * tile;
  const i64 row0 = (i64)blockIdx.y * blk;
#pragma unroll 1
  for (i64 r = 0; r < blk && row0 + r < B; ++r) {
    const i64 off = (row0 + r) * NL * T;
#pragma unroll 1
    for (i64 l = threadIdx.x; l < tile; l += blockDim.x) {
      const i64 t = lane0 + l;
      if (t >= T) break;
      int x[NL], y[NL], z[NL];
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        x[k] = a[off + k * T + t];
        y[k] = b[off + k * T + t];
      }
      mont_mul(x, y, C, z);
#pragma unroll
      for (int k = 0; k < NL; ++k) out[off + k * T + t] = z[k];
    }
  }
}

__device__ __forceinline__ int wrap_add(int u, int v) {
  return (int)((unsigned)u + (unsigned)v);
}

// o (R, T) = a + 1 (wrapping), both contiguous; block i owns the (R, tile)
// column block of lanes [i*tile, (i+1)*tile).  Index type I: unsigned when
// R*T < 2^31, else 64-bit.  With VEC, a and o share their offset `mis`
// (ints past a 16-byte boundary), and each row's segment is a scalar head
// up to the first 16-byte boundary, a body of int4s and a scalar tail;
// the block's int4s are dealt out row after row, COPY_UNROLL of them in
// flight per thread before its stores.  Without VEC every int is scalar.
template <typename I, bool VEC>
__global__ void __launch_bounds__(COPY_THREADS)
add_one_kernel(const int* __restrict__ a, int* __restrict__ o, I R, I T,
               I tile, I mis) {
  const I lane0 = (I)blockIdx.x * tile;
  const I len = T - lane0 < tile ? T - lane0 : tile;
  if (!VEC) {
    for (I r = 0; r < R; ++r)
      for (I l = threadIdx.x; l < len; l += COPY_THREADS)
        o[r * T + lane0 + l] = wrap_add(a[r * T + lane0 + l], 1);
    return;
  }
  // head, int4 count and tail of row r's segment, which starts at e
  auto split = [&](I e, I& head, I& n4) {
    head = (4 - ((e + mis) & 3)) & 3;
    if (head > len) head = len;
    n4 = (len - head) >> 2;
  };
  const I N4 = len >> 2;  // the most int4s a row can hold
  if (N4 > 0) {
    const I units = R * N4;
    I r = threadIdx.x / N4, v = threadIdx.x % N4;
    const I dr = COPY_THREADS / N4, dv = COPY_THREADS % N4;
    for (I u = threadIdx.x; u < units; u += COPY_UNROLL * COPY_THREADS) {
      int4 val[COPY_UNROLL];
      I idx[COPY_UNROLL];
      bool ok[COPY_UNROLL];
#pragma unroll
      for (int i = 0; i < COPY_UNROLL; ++i) {
        const I e = r * T + lane0;
        I head, n4;
        split(e, head, n4);
        ok[i] = u + i * COPY_THREADS < units && v < n4;
        idx[i] = e + head + 4 * v;
        if (ok[i]) val[i] = *reinterpret_cast<const int4*>(a + idx[i]);
        v += dv;
        r += dr;
        if (v >= N4) {
          v -= N4;
          ++r;
        }
      }
#pragma unroll
      for (int i = 0; i < COPY_UNROLL; ++i) {
        if (!ok[i]) continue;
        int4 x = val[i];
        x.x = wrap_add(x.x, 1);
        x.y = wrap_add(x.y, 1);
        x.z = wrap_add(x.z, 1);
        x.w = wrap_add(x.w, 1);
        *reinterpret_cast<int4*>(o + idx[i]) = x;
      }
    }
  }
  // the heads and tails: at most 3 + 3 ints a row
  for (I u = threadIdx.x; u < R * 8; u += COPY_THREADS) {
    const I r = u >> 3, i = u & 7;
    const I e = r * T + lane0;
    I head, n4;
    split(e, head, n4);
    const I tail = len - head - 4 * n4;
    I k;
    if (i < 3 && i < head)
      k = e + i;
    else if (i >= 4 && i - 4 < tail)
      k = e + head + 4 * n4 + (i - 4);
    else
      continue;
    o[k] = wrap_add(a[k], 1);
  }
}

// out (R, m-1) = [level 1 | level 2 | ... | level log2(m)] of the halving
// sum tree over x (R, m), m a power of two: level k+1 [j] = level k [j] +
// level k [j + width/2], level 0 = x.  One block per row.  Levels too wide
// for shared memory read their source from device memory (x, or the level
// this block has just written to out); the first level that fits is kept
// in shared memory and folded in place from there on.
__global__ void __launch_bounds__(UPSWEEP_THREADS)
fused_upsweep_kernel(const int* x, int* out, i64 m) {
  extern __shared__ int s[];
  const int* src = x + (i64)blockIdx.x * m;
  int* dst = out + (i64)blockIdx.x * (m - 1);
  i64 w = m;
  while (w / 2 > UPSWEEP_SMEM_INTS) {
    const i64 h = w / 2;
    for (i64 j = threadIdx.x; j < h; j += blockDim.x)
      dst[j] = wrap_add(src[j], src[j + h]);
    __syncthreads();
    src = dst;
    dst += h;
    w = h;
  }
  if (w > 1) {
    const i64 h = w / 2;
    for (i64 j = threadIdx.x; j < h; j += blockDim.x) {
      const int v = wrap_add(src[j], src[j + h]);
      s[j] = v;
      dst[j] = v;
    }
    __syncthreads();
    dst += h;
    w = h;
  }
  // in place: position j is read and written by the one thread that owns
  // j; position j + h is only read
  while (w > 1) {
    const i64 h = w / 2;
    for (i64 j = threadIdx.x; j < h; j += blockDim.x) {
      const int v = wrap_add(s[j], s[j + h]);
      s[j] = v;
      dst[j] = v;
    }
    __syncthreads();
    dst += h;
    w = h;
  }
}

extern "C" {

// pn: p and n' of the field (42 ints) in HOST memory
int zk_mm2d(const int* a, const int* b, int* out, const int* pn, i64 T,
            i64 tile, int chain, void* stream) {
  if (tile < 1 || chain < 0 || T < 1 || T >= ((i64)1 << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = tiles_for(T, tile);
  if (tile > T) tile = T;  // one block either way
  FieldPN f;
  for (int k = 0; k < 2 * NL; ++k) f.c[k] = pn[k];
  mm2d_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, f, (unsigned)T, (unsigned)tile, chain);
  return (int)cudaGetLastError();
}

int zk_mm3d(const int* a, const int* b, int* out, const int* consts, i64 B,
            i64 T, i64 tile, i64 blk, void* stream) {
  if (tile < 1 || blk < 1 || (B + blk - 1) / blk > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles_for(T, tile), tiles_for(B, blk));
  mm3d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, out, consts,
                                                          B, T, tile, blk);
  return (int)cudaGetLastError();
}

int zk_add_one(const int* a, int* o, i64 R, i64 T, i64 tile, void* stream) {
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = tiles_for(T, tile);
  if (tile > T) tile = T;  // one block either way
  const i64 mis = ((uintptr_t)a >> 2) & 3;
  const bool vec = (((uintptr_t)a ^ (uintptr_t)o) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (R * T < ((i64)1 << 31)) {
    typedef unsigned U;
    if (vec)
      add_one_kernel<U, true><<<blocks, COPY_THREADS, 0, s>>>(
          a, o, (U)R, (U)T, (U)tile, (U)mis);
    else
      add_one_kernel<U, false><<<blocks, COPY_THREADS, 0, s>>>(
          a, o, (U)R, (U)T, (U)tile, (U)mis);
  } else if (vec) {
    add_one_kernel<i64, true><<<blocks, COPY_THREADS, 0, s>>>(a, o, R, T,
                                                              tile, mis);
  } else {
    add_one_kernel<i64, false><<<blocks, COPY_THREADS, 0, s>>>(a, o, R, T,
                                                               tile, mis);
  }
  return (int)cudaGetLastError();
}

int zk_fused_upsweep(const int* x, int* out, i64 R, i64 m, void* stream) {
  if (m < 2 || (m & (m - 1))) return (int)cudaErrorInvalidValue;
  const i64 ints = m / 2 < UPSWEEP_SMEM_INTS ? m / 2 : UPSWEEP_SMEM_INTS;
  const int smem = (int)(ints * sizeof(int));
  cudaError_t rc = cudaFuncSetAttribute(
      fused_upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  fused_upsweep_kernel<<<(unsigned)R, UPSWEEP_THREADS, smem,
                         (cudaStream_t)stream>>>(x, out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
