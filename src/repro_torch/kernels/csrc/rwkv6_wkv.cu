// RWKV6 WKV recurrence, chunked, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/rwkv6_wkv.py::rwkv6_wkv_bh
// (_wkv_kernel, grid (B*H, chunks)). On the TPU the chunk axis is the
// sequential grid axis and the (hs, hs) state persists in VMEM scratch
// across it. Here one block owns one (batch, head) and loops over the
// chunks in order itself; the state stays in shared memory for the whole
// sequence and is written out once, as h_last.
//
// Per chunk of Lc steps, the TPU kernel's math, step for step:
//   L     = cumsum(lw) (inclusive), L_excl = L - lw       (log decays <= 0)
//   o     = (r * exp(L_excl)) @ h                          (inter-chunk)
//   o    += tril_strict(sum_i r[t,i] exp(min(L_excl[t,i] - L[s,i], 0))
//                       k[s,i]) @ v                        (intra-chunk)
//   o    += (sum_i r[t,i] u[i] k[t,i]) * v[t]              (bonus)
//   h     = exp(L_end) * h + (k * exp(L_end - L))^T @ v    (state update)
// The sequence is padded to a multiple of Lc with r = k = v = 0 and
// lw = 0 (a decay of 1), so the padding adds nothing to the state and
// h_last is exact.
//
// Layout: r, k, v (BH, S, hs) fp32 or bf16; lw (BH, S, hs), u (BH, hs) and
// h0 (BH, hs, hs) fp32; o (BH, S, hs) in r's type; h_last (BH, hs, hs)
// fp32. All arithmetic is fp32.
//
// What bounds it: at the serving path's prefill shape (B*H = 256,
// S = 512, hs = 64, Lc = 32) it moves 10 bytes per input element and
// does ~25 operations on it, so the byte bound is the least time; but each
// (batch, head) is a chain of S/Lc dependent chunks, and one block per
// chain gives only 256 blocks for 132 SMs. The design keeps everything
// of a chunk in shared memory (tiles with a padded row stride, so the
// pairwise-score loop reads without bank conflicts) and spends its
// threads on the chunk's three small products; the chain is the limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ h0,
               T* __restrict__ o, float* __restrict__ h_last, int S, int hs,
               int chunk) {
  const int P = hs + 1;           // padded row stride of the chunk tiles
  extern __shared__ float smem[];
  float* h = smem;                // [hs][hs]   the carried state
  float* rs = h + hs * hs;        // [Lc][P]    r, then r * exp(L_excl)
  float* ks = rs + chunk * P;     // [Lc][P]    k, then k * exp(L_end - L)
  float* vs = ks + chunk * P;     // [Lc][P]
  float* Ls = vs + chunk * P;     // [Lc][P]    lw, then inclusive cumsum
  float* Lx = Ls + chunk * P;     // [Lc][P]    L - lw
  float* sc = Lx + chunk * P;     // [Lc][Lc]   intra-chunk scores
  float* dg = sc + chunk * chunk; // [Lc]       bonus term
  float* us = dg + chunk;         // [hs]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)bh * S * hs;
  for (int i = tid; i < hs * hs; i += THREADS)
    h[i] = h0[(size_t)bh * hs * hs + i];
  for (int i = tid; i < hs; i += THREADS) us[i] = u[(size_t)bh * hs + i];

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    __syncthreads();   // the previous chunk's tiles are no longer read
    for (int i = tid; i < chunk * hs; i += THREADS) {
      const int t = i / hs, ch = i - t * hs;
      const bool in = t0 + t < S;
      const size_t g = base + (size_t)(t0 + t) * hs + ch;
      rs[t * P + ch] = in ? to_f(r[g]) : 0.f;
      ks[t * P + ch] = in ? to_f(k[g]) : 0.f;
      vs[t * P + ch] = in ? to_f(v[g]) : 0.f;
      Ls[t * P + ch] = in ? lw[g] : 0.f;
    }
    __syncthreads();
    // cumulative log decay along the chunk, one channel per thread
    for (int ch = tid; ch < hs; ch += THREADS) {
      float a = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float w = Ls[t * P + ch];
        a += w;
        Ls[t * P + ch] = a;
        Lx[t * P + ch] = a - w;
      }
    }
    __syncthreads();
    // intra-chunk scores (strictly lower triangular) and the bonus
    for (int i = tid; i < chunk * chunk; i += THREADS) {
      const int t = i / chunk, s = i - t * chunk;
      float acc = 0.f;
      if (s < t) {
        const float* rt = rs + t * P;
        const float* xt = Lx + t * P;
        const float* Lsr = Ls + s * P;
        const float* kr = ks + s * P;
        for (int ch = 0; ch < hs; ++ch)
          acc += rt[ch] * expf(fminf(xt[ch] - Lsr[ch], 0.f)) * kr[ch];
      }
      sc[i] = acc;
    }
    for (int t = tid; t < chunk; t += THREADS) {
      float acc = 0.f;
      for (int ch = 0; ch < hs; ++ch)
        acc += rs[t * P + ch] * us[ch] * ks[t * P + ch];
      dg[t] = acc;
    }
    __syncthreads();
    // decayed r (for the state term) and decayed k (for the update)
    const float* Lend = Ls + (chunk - 1) * P;
    for (int i = tid; i < chunk * hs; i += THREADS) {
      const int t = i / hs, ch = i - t * hs;
      rs[t * P + ch] = rs[t * P + ch] * expf(Lx[t * P + ch]);
      ks[t * P + ch] = ks[t * P + ch] * expf(Lend[ch] - Ls[t * P + ch]);
    }
    __syncthreads();
    // outputs, against the state as it was at the chunk's start
    for (int i = tid; i < chunk * hs; i += THREADS) {
      const int t = i / hs, j = i - t * hs;
      if (t0 + t >= S) continue;
      float a = 0.f;
      for (int ch = 0; ch < hs; ++ch) a += rs[t * P + ch] * h[ch * hs + j];
      float b = 0.f;
      for (int s = 0; s < t; ++s) b += sc[t * chunk + s] * vs[s * P + j];
      float out = a + b;
      out = out + dg[t] * vs[t * P + j];
      o[base + (size_t)(t0 + t) * hs + j] = from_f<T>(out);
    }
    __syncthreads();
    // state update
    for (int i = tid; i < hs * hs; i += THREADS) {
      const int ch = i / hs, j = i - ch * hs;
      float a = 0.f;
      for (int s = 0; s < chunk; ++s) a += ks[s * P + ch] * vs[s * P + j];
      h[i] = expf(Lend[ch]) * h[i] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < hs * hs; i += THREADS)
    h_last[(size_t)bh * hs * hs + i] = h[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* h0, void* o, float* h_last, int bh,
           int S, int hs, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)hs * hs + 5 * chunk * (hs + 1)
                                       + chunk * chunk + chunk + hs);
  auto* fn = wkv_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<bh, THREADS, smem, stream>>>((const T*)r, (const T*)k, (const T*)v,
                                    lw, u, h0, (T*)o, h_last, S, hs, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of r, k, v and o: 0 = float32, 1 = bfloat16. Returns the CUDA
// error of the launch.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const float* lw, const float* u,
                             const float* h0, void* o, float* h_last,
                             int bh, int S, int hs, int chunk, int dtype,
                             void* stream) {
  if (bh <= 0 || S <= 0 || hs <= 0 || chunk <= 0 || chunk > 64 || hs > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, lw, u, h0, o, h_last, bh, S, hs, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, lw, u, h0, o, h_last, bh, S, hs,
                                 chunk, st);
  return (int)cudaErrorInvalidValue;
}
