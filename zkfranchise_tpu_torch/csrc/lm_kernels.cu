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
// Design: one thread per lane (element or point) carries the 21-limb
// schoolbook in registers and repeats the plain PyTorch version's steps
// in the same order (ops/lm.py mont_reduce with its carry trick; ops/ec_lm
// RCB15 in three product rounds with the lazy Fq2 products and the lazy
// round 3), so every output limb equals the plain version's.  Neighbouring
// threads own neighbouring lanes, so every limb-row load and store is
// coalesced; the constants block is staged in shared memory per block.
//
// What bounds them on an H100: integer multiply-adds.  A Montgomery
// product is 441 + 231 + 441 = 1113 multiply-adds on 168-252 bytes of
// traffic, a G1 add 13,566 on 756 bytes, a G2 add 39,480 on 1,512 bytes:
// all four are compute-bound by a wide margin, never memory-bound.  This
// first version does nothing about it beyond keeping limbs in registers
// and reading every input once; the G2 add's two 126-row points alone
// exceed the 255-register limit, so it spills to local memory (L1).
// Tuning (limb layout, shared-memory staging, fewer reductions) is later
// work.
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

// out (B, rows, T) = p + q, p and q (B, rows, T) with the given batch and
// row strides and lane stride 1
template <int K>
__global__ void __launch_bounds__(THREADS)
padd_kernel(const int* __restrict__ p, const int* __restrict__ q,
            int* __restrict__ out, const int* __restrict__ consts, i64 B,
            i64 T, i64 pbs, i64 prs, i64 qbs, i64 qrs) {
  __shared__ int C[EC_CONSTS];
  stage_consts(consts, C, EC_CONSTS);
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * T) return;
  const i64 b = idx / T, t = idx % T;
  padd_point<K>(p + b * pbs + t, prs, q + b * qbs + t, qrs,
                out + b * (3 * K * NL) * T + t, T, C);
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

int zk_padd(int k, const int* p, const int* q, int* out, const int* consts,
            i64 B, i64 T, i64 pbs, i64 prs, i64 qbs, i64 qrs, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    padd_kernel<1><<<blocks_for(B * T), THREADS, 0, s>>>(p, q, out, consts, B,
                                                         T, pbs, prs, qbs, qrs);
  else
    padd_kernel<2><<<blocks_for(B * T), THREADS, 0, s>>>(p, q, out, consts, B,
                                                         T, pbs, prs, qbs, qrs);
  return (int)cudaGetLastError();
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
