// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/flash_attention.py::flash_attention_bhsd
// (_flash_fwd_kernel, grid (B*H, q_blocks, kv_blocks)). On the TPU the kv
// axis is the innermost, sequential grid axis and the online-softmax
// accumulators live in VMEM scratch across it; blocks here run in no
// order, so one block owns a tile of BQ query rows of one (batch, head)
// and walks the KV tiles itself, keeping m, l and the fp32 accumulator in
// registers.
//
// Layout: q (BH, S, D), k and v (BH, T, D), contiguous, fp32 or bf16;
// o (BH, S, D) in q's type. Masks: kpos < T always; with causal,
// kpos <= qpos (positions counted from 0 in both, start-aligned, as the
// TPU kernel does) and the KV tiles above the diagonal are skipped.
// Scores, m, l and the accumulator are fp32; masked scores are -1e30, as
// in the TPU kernel, and l is floored at 1e-30.
//
// What bounds it: at the serving path's prefill shape (S = T = 512,
// D = 64, bf16) one (batch, head) does 4*S*T*D operations in its two
// products on 2*(S+T)*D*2 bytes, 256 per byte: near the ~295 at which the
// H100's bf16 tensor cores, and not its memory, become the limit; at the
// decode shape (S = 1) it is the bytes by far. This version computes on
// the CUDA cores in fp32, register-blocked: each lane holds the scores of
// its two keys for all of its warp's rows, so one shared-memory load of
// K (transposed in shared memory) or V feeds RPW fused multiply-adds and
// the rows of Q and P are read as float4 broadcasts; the tiles come from
// global memory in 16-byte loads. wgmma tiles are the later step.
//
// Built for D = 64 in fp32 and bf16: the only head size on a path that
// reaches the kernel (seamless-m4t's cross-attention, bf16) and its fp32
// twin. The wrapper refuses any other D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 64;       // keys per KV tile (two per lane)
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// N floats (a multiple of 4) to 16-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void store_f4(float* dst, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

// 16 bytes of a row (8 bf16 or 4 fp32 elements) as floats
template <typename T> __device__ __forceinline__ void unpack(uint4 u, float* f);
template <> __device__ __forceinline__ void unpack<float>(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 u,
                                                                  float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_,
                 int n_qblocks, float scale, int causal) {
  constexpr int DPL = D / 32;       // output dims per lane
  constexpr int KT = BK + 1;        // padded row stride of the K^T tile
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = D / VEC;            // 16-byte chunks per row
  constexpr int THREADS = WARPS * 32;
  constexpr int QLD = BQ * CPR / THREADS;  // chunks per thread: Q tile
  constexpr int KLD = BK * CPR / THREADS;  // and each of K, V tiles
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D]
  float* kt = qs + BQ * D;          // [D][BK+1], K transposed
  float* vs = kt + D * KT;          // [BK][D]
  float* ps = vs + BK * D;          // [WARPS][RPW][BK], this tile's P

  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * RPW;      // the warp's first row in the block
  // a warp whose rows all lie past S (all but one warp at a decode step)
  // loads tiles with the others but computes nothing
  const bool active = q0 + row0 < S;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)bh * T_ * D;
  const T* vb = v + (size_t)bh * T_ * D;
  float* pw = ps + warp * RPW * BK;

  // tiles are read in 16-byte chunks, all of a thread's loads issued
  // before the first is used, so a tile costs one memory latency
#pragma unroll
  for (int j = 0; j < QLD; ++j) {
    const int ch = tid + j * THREADS;
    const int r = ch / CPR, c0 = (ch - r * CPR) * VEC;
    const uint4 u = (q0 + r < S) ? *reinterpret_cast<const uint4*>(
                                       qb + (size_t)(q0 + r) * D + c0)
                                 : make_uint4(0u, 0u, 0u, 0u);
    float f[VEC];
    unpack<T>(u, f);
    store_f4<VEC>(qs + r * D + c0, f);
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = 0.f;
  }

  const int n_tiles = (T_ + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    // causal: tiles wholly above this block's diagonal contribute nothing
    if (causal && k0 > q0 + BQ - 1) break;
    __syncthreads();   // the previous tile is no longer read
    uint4 ku[KLD], vu[KLD];
#pragma unroll
    for (int j = 0; j < KLD; ++j) {
      const int ch = tid + j * THREADS;
      const int r = ch / CPR, c0 = (ch - r * CPR) * VEC;
      const size_t off = (size_t)(k0 + r) * D + c0;
      const bool in = k0 + r < T_;
      ku[j] = in ? *reinterpret_cast<const uint4*>(kb + off)
                 : make_uint4(0u, 0u, 0u, 0u);
      vu[j] = in ? *reinterpret_cast<const uint4*>(vb + off)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < KLD; ++j) {
      const int ch = tid + j * THREADS;
      const int r = ch / CPR, c0 = (ch - r * CPR) * VEC;
      float f[VEC];
      unpack<T>(ku[j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) kt[(c0 + e) * KT + r] = f[e];
      unpack<T>(vu[j], f);
      store_f4<VEC>(vs + r * D + c0, f);
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for the warp's RPW rows and this lane's keys lane, lane+32
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ka[e] = kt[(d + e) * KT + lane];
        kc[e] = kt[(d + e) * KT + lane + 32];
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (row0 + rr) * D + d);
        s[rr][0] += qv.x * ka[0] + qv.y * ka[1] + qv.z * ka[2] + qv.w * ka[3];
        s[rr][1] += qv.x * kc[0] + qv.y * kc[1] + qv.z * kc[2] + qv.w * kc[3];
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qpos = q0 + row0 + rr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool valid = kpos < T_;
        if (causal) valid = valid && (kpos <= qpos);
        s[rr][j] = valid ? s[rr][j] * scale : NEG_INF;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s[rr][0], s[rr][1])));
      const float p0 = expf(s[rr][0] - m_new);
      const float p1 = expf(s[rr][1] - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] *= alpha;
      m[rr] = m_new;
      pw[rr * BK + lane] = p0;
      pw[rr * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V: lane owns output dims lane + 32*dd
#pragma unroll 2
    for (int key = 0; key < BK; key += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          vv[e][dd] = vs[(key + e) * D + lane + 32 * dd];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 p = *reinterpret_cast<const float4*>(pw + rr * BK + key);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[rr][dd] += p.x * vv[0][dd] + p.y * vv[1][dd] + p.z * vv[2][dd] +
                         p.w * vv[3][dd];
      }
    }
    __syncwarp();      // P is rewritten by the next tile
  }

  T* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qpos = q0 + row0 + rr;
    if (qpos < S) {
      const float lv = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        ob[(size_t)qpos * D + lane + 32 * dd] = from_f<T>(acc[rr][dd] / lv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int S, int T_, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * D + D * (BK + 1) + BK * D + WARPS * RPW * BK);
  auto* fn = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (S + BQ - 1) / BQ;
  const float scale = 1.0f / sqrtf((float)D);
  fn<<<bh * nqb, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, T_, nqb, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 64. Returns the CUDA error
// of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bh, int S,
                                   int T, int D, int dtype, int causal,
                                   void* stream) {
  if (bh <= 0 || S <= 0 || T <= 0 || D != 64)
    return (int)cudaErrorInvalidValue;
  // the tiles are read 16 bytes at a time
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15u)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float, 64>(q, k, v, o, bh, S, T, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(q, k, v, o, bh, S, T, causal, st);
  return (int)cudaErrorInvalidValue;
}
