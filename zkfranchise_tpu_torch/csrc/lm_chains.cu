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
// Design: one thread per lane, limbs in registers, the plain PyTorch
// versions' steps in the same order (a square is the same mont_mul as any
// product), so every output limb equals the plain version's.  The exponent
// bits are staged in shared memory; a bit is the same for every thread of
// the grid, so the plain version's select on the bit is a branch here, and
// the product that a zero bit would discard is not computed.
//
// What bounds them on an H100: integer multiply-adds, 1,113 per Montgomery
// product against 168-252 bytes of traffic.  fold_mul fills the card like
// mont_mul.  inv is a chain of hundreds of DEPENDENT products per lane and
// is called with as many lanes as there are rows in a batch (128): one
// block on one of 132 SMs, bound by the latency of the chain and far above
// its operations bound.  mont_chain keeps x in registers across the chain
// and so shows the card's multiply-add rate without memory traffic.
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

// out = a^e over T lanes, e given LSB first as nbits 0/1 ints; limb k of
// lane t of a at a[k*sal + t*sat], of out at out[k*sol + t*sot].  consts:
// the field block (p, n', sub_d, one_mont, ...).
__global__ void __launch_bounds__(THREADS)
inv_kernel(const int* __restrict__ a, int* __restrict__ out,
           const int* __restrict__ consts, const int* __restrict__ bits,
           int nbits, i64 T, i64 sal, i64 sat, i64 sol, i64 sot) {
  __shared__ int C[4 * NL];
  __shared__ int sbits[MAX_BITS];
  for (int i = threadIdx.x; i < nbits; i += blockDim.x) sbits[i] = bits[i];
  stage_consts(consts, C, 4 * NL);
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int acc[NL], base[NL], tmp[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    acc[k] = C[C_ONE + k];
    base[k] = a[k * sal + t * sat];
  }
#pragma unroll 1
  for (int i = 0; i < nbits; ++i) {
    if (sbits[i] == 1) {
      mont_mul(acc, base, C, tmp);
#pragma unroll
      for (int k = 0; k < NL; ++k) acc[k] = tmp[k];
    }
    mont_mul(base, base, C, tmp);
#pragma unroll
    for (int k = 0; k < NL; ++k) base[k] = tmp[k];
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) out[k * sol + t * sot] = acc[k];
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
  inv_kernel<<<blocks_for(T), THREADS, 0, (cudaStream_t)stream>>>(
      a, out, consts, bits, nbits, T, sal, sat, sol, sot);
  return (int)cudaGetLastError();
}

int zk_mont_chain(const int* a, const int* b, int* out, const int* consts,
                  i64 T, int iters, void* stream) {
  mont_chain_kernel<<<blocks_for(T), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, consts, T, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
