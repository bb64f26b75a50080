// Error-feedback int8 wire round-trips for the uplink codecs (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/ef_codec.py::
// ef_int8_roundtrip (_int8_kernel) and ::ef_topk_int8_roundtrip
// (_topk_int8_kernel). Both are memory-bound: per element they read x and
// the residual and write the decoded value and the new residual (16
// bytes) for a handful of flops.
//
// Design: two kernels on the caller's stream.
//   1. amax: a grid-stride max of |x + r| (of the kept coordinates when a
//      top-k threshold is given). The values are >= 0, so their IEEE bit
//      patterns order like the floats: each block reduces the bits with
//      __reduce_max_sync and issues one atomicMax. Max is exact, so the
//      result does not depend on the order blocks run in. A NaN (bits
//      above +inf) wins the max, as jnp.max propagates it.
//   2. apply: scale = max(amax, 1e-30) / 127, q = clip(rint(xc / scale)),
//      dec = q * scale, r' = xc - dec, elementwise.
// rintf rounds half to even like jnp.round. The products and differences
// use the _rn intrinsics and the file is built with -fmad=false, so no
// multiply-add is contracted and dec + r' == x + r holds exactly.
// The second pass reads x and r again: 24 bytes moved per element where
// the bound counts 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;

__global__ void amax_kernel(const float* __restrict__ x,
                            const float* __restrict__ r, long long n,
                            const float* __restrict__ thresh,
                            unsigned* __restrict__ amax_bits) {
  const float t = thresh ? *thresh : 0.0f;
  unsigned m = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float a = fabsf(__fadd_rn(x[i], r[i]));
    if (thresh && !(a >= t)) a = 0.0f;
    m = max(m, __float_as_uint(a));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0) atomicMax(amax_bits, v);
  }
}

__global__ void apply_kernel(const float* __restrict__ x,
                             const float* __restrict__ r, long long n,
                             const float* __restrict__ thresh,
                             const unsigned* __restrict__ amax_bits,
                             float* __restrict__ dec,
                             float* __restrict__ rout) {
  const float amax = __uint_as_float(*amax_bits);
  // jnp.maximum propagates NaN where fmaxf would drop it
  const float floor_amax = (amax != amax) ? amax : fmaxf(amax, 1e-30f);
  const float scale = __fdiv_rn(floor_amax, kQmax);
  const float t = thresh ? *thresh : 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xc = __fadd_rn(x[i], r[i]);
    const bool kept = !thresh || fabsf(xc) >= t;
    float q = rintf(__fdiv_rn(kept ? xc : 0.0f, scale));
    // clip that keeps NaN, as jnp.clip does
    q = q < -kQmax ? -kQmax : (q > kQmax ? kQmax : q);
    const float d = kept ? __fmul_rn(q, scale) : 0.0f;
    dec[i] = d;
    rout[i] = __fsub_rn(xc, d);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;   // 16 resident blocks on each of 132 SMs
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// (decoded, residual') of x + r, int8 against the amax of the kept
// coordinates. thresh == nullptr keeps every coordinate (int8_ef); else
// coordinates with |x + r| >= *thresh are kept and the rest decode to 0
// (topk_int8_ef). scratch: one uint32 of device memory.
extern "C" int ef_roundtrip(const float* x, const float* r,
                            const float* thresh, float* dec, float* rout,
                            unsigned* scratch, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const int grid = grid_for(n);
  amax_kernel<<<grid, kThreads, 0, s>>>(x, r, n, thresh, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_kernel<<<grid, kThreads, 0, s>>>(x, r, n, thresh, scratch, dec, rout);
  return (int)cudaGetLastError();
}
