// Hand-written Hopper (sm_90a) kernel for one butterfly level of the NTT
// over BN254 Fr on the limb-major core (layout and device functions:
// lm_device.cuh).
//
//   zk_ntt_level  <- mont_mul (zkfranchise_tpu/ops/pallas/lm_kernels.py
//                    _mont_mul_kernel) as the NTT calls it
//                    (zkfranchise_tpu/ops/ntt.py _transform), together with
//                    the glue around it that XLA fuses on the TPU: the row
//                    gather, the lazy add and the spread-constant subtract
//
// One level of ops/ntt.py _transform (its plain version, ntt_level_ref):
// x (n, 21, T) Montgomery, the level's gather g (n,) int64 and twiddles tw
// (n/2, 21, 1).  For each pair j < h = n/2 and lane t:
//   lo = x[g[j]], hi = mont(x[g[h + j]], tw[j]),
//   y[j] = weak_norm(lo + hi), y[h + j] = weak_norm(lo + (sub_d - hi)),
// the plain version's steps in its order, so every limb equals it.
//
// What bounds it on an H100: bytes.  A level reads x once (through g, so
// x[g] is never written out), the twiddles and the indices, and writes y:
// at n = 2^14, T = 128 about 353 MB, 0.105 ms at 3.35 TB/s; its Karatsuba
// products (915 multiply-adds each) come to about 0.057 ms at the integer
// ceiling.  Design: one thread per (pair, lane), lanes on neighbouring
// threads, so each limb row of lo, hi and y is one coalesced access; a
// twiddle column and the pair's two indices have the same address across
// a warp's lanes (one broadcast load each); the product stays in
// registers.  A block is tx lanes by THREADS / tx pairs (ops/cuda/
// lm_kernels.py lane_block), so a narrow lane axis (the stream's last
// slices, T = 8 and 4) still fills the warps.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

// consts: the field block of ops/lm.pack_consts (p, n', sub_d, ...)
__global__ void __launch_bounds__(THREADS)
ntt_level_kernel(const int* __restrict__ x, const i64* __restrict__ g,
                 const int* __restrict__ tw, int* __restrict__ y,
                 const int* __restrict__ consts, i64 h, i64 T) {
  __shared__ int C[3 * NL];
  stage_consts(consts, C, 3 * NL);
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const i64 row = NL * T;
  for (i64 j = (i64)blockIdx.y * blockDim.y + threadIdx.y; j < h;
       j += (i64)gridDim.y * blockDim.y) {
    const int* plo = x + __ldg(g + j) * row + t;
    const int* phi = x + __ldg(g + h + j) * row + t;
    const int* pw = tw + j * NL;
    int lo[NL], hi[NL], w[NL], m[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      lo[k] = plo[k * T];
      hi[k] = phi[k * T];
      w[k] = __ldg(pw + k);
    }
    mont_mul_karatsuba(hi, w, C, m);
    int s[NL], d[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      s[k] = lo[k] + m[k];
      d[k] = lo[k] + (C[C_SUBD + k] - m[k]);
    }
    weak_norm<NL>(s);
    weak_norm<NL>(d);
    int* ps = y + j * row + t;
    int* pd = y + (h + j) * row + t;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      ps[k * T] = s[k];
      pd[k * T] = d[k];
    }
  }
}

extern "C" {

// x, y (2h, 21, T) contiguous, g (2h,) int64, tw (h, 21, 1) contiguous; tx:
// lanes a block (a power of two <= THREADS)
int zk_ntt_level(const int* x, const i64* g, const int* tw, int* y,
                 const int* consts, i64 h, i64 T, int tx, void* stream) {
  const dim3 block(tx, THREADS / tx);
  const dim3 grid(lane_blocks(T, tx), grid_cap(h, THREADS / tx));
  ntt_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, g, tw, y, consts, h, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
