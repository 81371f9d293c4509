// Hand-written Hopper (sm_90a) kernel for the Poseidon permutation over
// BN254 Fr on the limb-major core (layout and device functions:
// lm_device.cuh).
//
// Kernel and the TPU kernel it replaces:
//   zk_poseidon  <- mont_mul (zkfranchise_tpu/ops/pallas/lm_kernels.py
//                   _mont_mul_kernel) as the witness launches it: three
//                   products a S-box and t a row of the MDS mix, each one
//                   launch (ops/poseidon.py, models/census.py
//                   eval_poseidon_trace).  Here the whole permutation of
//                   width t (3, 4 or 5) runs in ONE launch for every lane.
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
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() of its launch.

#include "lm_device.cuh"

#define LANES 32
#define R_F 8

extern __shared__ int psmem[];

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
  const int rounds = R_F + r_p, half = R_F / 2;
  int* C = psmem;                        // p, n'
  int* CR = C + 2 * NL;                  // round constants
  int* MM = CR + rounds * TW * NL;       // MDS matrix
  int* S = MM + TW * TW * NL;            // two state buffers
  for (int i = threadIdx.x; i < 2 * NL; i += blockDim.x) C[i] = consts[i];
  for (int i = threadIdx.x; i < rounds * TW * NL; i += blockDim.x)
    CR[i] = c_mont[i];
  for (int i = threadIdx.x; i < TW * TW * NL; i += blockDim.x)
    MM[i] = m_mont[i];
  const int e = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 g = (i64)blockIdx.x * LANES + lane;
  const bool ok = g < T;
  const int src = e - zero_first;
  int s[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k)
    s[k] = ok && src >= 0 ? x[((i64)src * NL + k) * T + g] : 0;
  __syncthreads();
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
        if (trace != nullptr && ok) {
          int* tr = trace + (i64)(row + 3 * e + i) * NL * T + g;
#pragma unroll
          for (int k = 0; k < NL; ++k) tr[k * T] = y[k];
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
  if (ok && (whole || e == 0)) {
#pragma unroll
    for (int k = 0; k < NL; ++k) out[((i64)e * NL + k) * T + g] = s[k];
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

}  // extern "C"
