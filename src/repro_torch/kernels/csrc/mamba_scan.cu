// Mamba selective scan (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = h_t . C_t
// over (B, S, dI) inputs with N states per channel, fp32.
//
// Replaces the JAX package's Pallas kernel kernels/mamba_scan.py::
// mamba_scan_bd (_mamba_kernel). The TPU kernel walks its grid's chunk
// axis in order with the (bd, N) state in VMEM and forms (Lc, bd, N) tiles
// of exp(dt A) and dt x B per chunk. On Hopper the state is registers: one
// thread owns one (batch, channel) and holds its N states, walking t in
// order; nothing of size (S, dI, N) is ever formed. Per chunk of `chunk`
// steps the block stages B_t and C_t, which every channel of the batch
// shares, in shared memory; dt and x are read straight from device memory,
// neighbouring threads on neighbouring channels, so every load is
// coalesced. The loop stops at S, so a ragged last chunk leaves h_last
// exact, as the TPU kernel's padding with dt = 0 does. `chunk` and the
// block width only set the schedule.
//
// What bounds it: bytes (dt, x read and y written once: 12 bytes per
// (b, t, channel)), and near them the N exps per (b, t, channel) on the
// special-function units. Fused multiply-adds are allowed: the kernel is
// held to its plain version within a float tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kDefaultSmem = 48 * 1024;

template <int N>
__global__ void mamba_scan_kernel(const float* __restrict__ dt,
                                  const float* __restrict__ x,
                                  const float* __restrict__ Bm,
                                  const float* __restrict__ Cm,
                                  const float* __restrict__ A,
                                  const float* __restrict__ h0,
                                  float* __restrict__ y,
                                  float* __restrict__ h_last, int S, int dI,
                                  int chunk) {
  extern __shared__ float smem[];
  float* sB = smem;                 // (chunk, N)
  float* sC = smem + chunk * N;     // (chunk, N)
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = c < dI;
  float a[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = on ? A[(long long)c * N + i] : 0.0f;
    h[i] = on ? h0[((long long)b * dI + c) * N + i] : 0.0f;
  }
  const long long row = (long long)b * S;       // (b, 0) in (B, S, .)
  for (int t0 = 0; t0 < S; t0 += chunk) {
    const int L = min(chunk, S - t0);
    __syncthreads();                             // the last chunk is read
    const float* gB = Bm + (row + t0) * N;
    const float* gC = Cm + (row + t0) * N;
    for (int j = threadIdx.x; j < L * N; j += blockDim.x) {
      sB[j] = gB[j];
      sC[j] = gC[j];
    }
    __syncthreads();
    if (on) {
      const long long off = (row + t0) * dI + c;
      const float* pdt = dt + off;
      const float* px = x + off;
      float* py = y + off;
#pragma unroll 4
      for (int t = 0; t < L; ++t) {
        const float d = __ldg(pdt + (long long)t * dI);
        const float dx = d * __ldg(px + (long long)t * dI);
        const float* bt = sB + t * N;
        const float* ct = sC + t * N;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          h[i] = expf(d * a[i]) * h[i] + dx * bt[i];
          acc += h[i] * ct[i];
        }
        py[(long long)t * dI] = acc;
      }
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      h_last[((long long)b * dI + c) * N + i] = h[i];
  }
}

template <int N>
int launch(const float* dt, const float* x, const float* Bm, const float* Cm,
           const float* A, const float* h0, float* y, float* h_last, int B,
           int S, int dI, int chunk, int bd, cudaStream_t s) {
  const size_t smem = (size_t)2 * chunk * N * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((dI + bd - 1) / bd, B);
  mamba_scan_kernel<N><<<grid, bd, smem, s>>>(dt, x, Bm, Cm, A, h0, y,
                                              h_last, S, dI, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x: (B, S, dI); Bm, Cm: (B, S, N); A: (dI, N); h0: (B, dI, N); all
// fp32 and contiguous. Writes y (B, S, dI) and h_last (B, dI, N). N is 4
// or 16, the configs' d_state; bd threads a block (a multiple of 32, at most 1,024); chunk
// steps of B and C staged at a time.
extern "C" int mamba_scan(const float* dt, const float* x, const float* Bm,
                          const float* Cm, const float* A, const float* h0,
                          float* y, float* h_last, int B, int S, int dI,
                          int N, int chunk, int bd, void* stream) {
  if (B < 1 || S < 0 || dI < 1 || N < 1 || chunk < 1 ||
      bd < 32 || bd > 1024 || bd % 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA_CASE(n) \
  case n:             \
    return launch<n>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, chunk, bd, s);
  switch (N) {
    MAMBA_CASE(4) MAMBA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_CASE
}
