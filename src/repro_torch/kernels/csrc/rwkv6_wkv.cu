// RWKV6 WKV recurrence, chunked, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/rwkv6_wkv.py::rwkv6_wkv_bh
// (_wkv_kernel, grid (B*H, chunks)) and its model-layout wrapper rwkv6_wkv.
// On the TPU the chunk axis is the sequential grid axis and the (hs, hs)
// state persists in VMEM scratch across it. Here a block owns one (batch,
// head), or a slice of its value columns, and walks the chunks itself.
//
// The TPU kernel's math, per chunk of Lc steps:
//   L     = cumsum(lw) (inclusive), L_excl = L - lw       (log decays <= 0)
//   o     = (r * exp(L_excl)) @ h                          (inter-chunk)
//   o    += tril_strict(sum_i r[t,i] exp(min(L_excl[t,i] - L[s,i], 0))
//                       k[s,i]) @ v                        (intra-chunk)
//   o    += (sum_i r[t,i] u[i] k[t,i]) * v[t]              (bonus)
//   h     = exp(L_end) * h + (k * exp(L_end - L))^T @ v    (state update)
// The sequence is padded to a multiple of Lc with r = k = v = 0 and
// lw = 0 (a decay of 1), so the padding adds nothing to the state and
// h_last is exact at any S.
//
// Layout: the model's, read in place. r, k, v (bf16 or fp32) and lw (fp32)
// are (B, S, H, hs), each with its own batch, position and head strides
// and a contiguous last axis; u is (H, hs), fp32 or bf16, indexed by head;
// h0 and h_last are (B, H, hs, hs) fp32, contiguous; o is (B, S, H, hs),
// contiguous, in r's type, so that the model's o.reshape(B, S, D) is a
// view. The reference's (BH, S, hs) layout is B = 1 with BH heads. Head
// sizes 16, 64 and 128, chunks 16 and 32; anything else is refused here. The
// chunk only sets the schedule, so the Python wrapper runs any other
// positive chunk at a built one (rwkv6_wkv.py, kernel_chunk).
//
// What bounds it. At rwkv6-1.6b's prefill (B*H = 256, S = 512, hs = 64,
// Lc = 32, bf16) a call moves 10 bytes an input element plus the state
// once: ~100 MB, 0.03 ms at 3.35 TB/s. The work is small against that, but
// each (b, h) is a chain of S/Lc dependent chunks. Three kernels:
//
// - wkv_chunk_mma (bf16, S > 1): the path's prefill kernel. The "chain"
//   warps (one per 16 value columns) own the state in registers and do
//   what reads it: o += r~ @ h and the update. Four "prep" warps load each
//   chunk one chunk ahead (cp.async, two buffers) and do what does not
//   read it: the decays, the decayed r and k, the off-diagonal scores.
//   Chunk c's chain (by the chain warps) runs beside chunk c+1's loads and
//   decays (by the prep warps), each side on its own stage of shared
//   memory; then all warps take chunk c+1's pairwise scores together, and
//   two CTA-wide named barriers hand over (SCANNED: chunk c+1's decays
//   are in and chunk c's chain is done; FULL: its scores are in).
//   * Decays are products, not exponentials: w = exp(lw) once a step, and
//     every decay the chunk needs is a running product of w: a prep warp
//     takes a quarter of 8 steps, a lane a channel pair, and the quarters'
//     products meet in shared memory (exp(L_excl[t]), exp(L_end - L[s]),
//     the diagonal pairs' exp(L_excl[t] - L[s]) for s < t). A product of
//     factors <= 1 cannot overflow, and underflows to 0 as the exponential
//     does.
//   * Sub-chunks of 16: the off-diagonal block of the scores (t in the
//     second sub-chunk, s in the first) factors exactly as
//     (r[t] exp(L_excl[t] - L[15])) . (k[s] exp(L[15] - L[s])), both
//     factors <= 1, and runs on the tensor cores (the four prep warps, the
//     key channels split in two halves the chain adds); only the two
//     diagonal 16 x 16 blocks stay pairwise, on the CUDA cores (see
//     `pairwise`). The bonus is the scores' diagonal, so scores @ v adds
//     it.
//   * Products: mma.sync.m16n8k16 bf16 -> fp32 with ldmatrix. An fp32
//     operand x is split as hi = bf16(x), lo = bf16(x - hi) and a product
//     takes hi*hi + lo*hi + hi*lo (v, r, k are bf16 already, so a product
//     with v takes two passes): about 2^-16 relative per term, the fp32
//     accuracy that the 16-chunk state carry and its 1e-4 check need. The
//     state is held transposed (h^T[j][i]) as m16n8 accumulator fragments,
//     which are at once the B operand of r~ @ h and the accumulator of
//     h^T += v^T k~: the state never touches shared memory.
//   * One block a (b, h): splitting a (b, h) over blocks by value column
//     (each redoing the decays and scores, the kernel's bound) measured
//     slower both where 256 blocks fill the card and at one request's
//     32 blocks, so the card gets B * H blocks, two to an SM.
// - wkv_decode (S = 1, either type): bound by the state's bytes (read and
//   written once, 32 KB a (b, h) at hs 64). A block owns 16 value columns
//   of one (b, h), a thread one row's 4 columns as a float4 (hs * 4
//   threads: 512 at hs 128).
// - wkv_witness (fp32 on the path, and bf16 at hs 128; bf16 as the
//   witness the mma kernel is held against on the card): the CUDA-core
//   kernel, one block a (b, h), the chunk's tiles in shared memory, every
//   product a scalar loop. At hs 128 the mma kernel's layout (a chain
//   warp for every 16 value columns beside four prep warps) would take 12
//   warps and ~200 KB a block, so that size runs here: a simple
//   kernel, slower than the tensor cores would be.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BAD_ARGS = -1;     // arguments outside what the kernels take
constexpr int PREP = 128;        // prep threads of the mma kernel
constexpr int WIT_THREADS = 256;

struct Strides {
  long long b, s, h;  // element strides of the batch, position, head axes
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const void* u;
  const float* h0;
  void* o;
  float* h_last;
  int B, S, H, hs, chunk;
  Strides rs, ks, vs, ws;
  int u_bf16;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float u_at(const Args& a, int h, int i) {
  const size_t at = (size_t)h * a.hs + i;
  return a.u_bf16 ? __bfloat162float(((const bf16*)a.u)[at])
                  : ((const float*)a.u)[at];
}

// ---------------------------------------------------------------------------
// the CUDA-core kernel: fp32 on the path, and the witness
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(WIT_THREADS) wkv_witness(Args a) {
  const int hs = a.hs, S = a.S, chunk = min(a.chunk, a.S);
  const int P = hs + 1;           // padded row stride of the chunk tiles
  extern __shared__ float wit_smem[];
  float* h = wit_smem;            // [hs][hs]   the carried state
  float* rs = h + hs * hs;        // [Lc][P]    r, then r * exp(L_excl)
  float* ks = rs + chunk * P;     // [Lc][P]    k, then k * exp(L_end - L)
  float* vs = ks + chunk * P;     // [Lc][P]
  float* Ls = vs + chunk * P;     // [Lc][P]    lw, then inclusive cumsum
  float* Lx = Ls + chunk * P;     // [Lc][P]    L - lw
  float* sc = Lx + chunk * P;     // [Lc][Lc]   intra-chunk scores
  float* dg = sc + chunk * chunk; // [Lc]       bonus term
  float* us = dg + chunk;         // [hs]

  const int bh = blockIdx.x, b = bh / a.H, hh = bh - b * a.H;
  const int tid = threadIdx.x;
  const T* rg = (const T*)a.r + b * a.rs.b + hh * a.rs.h;
  const T* kg = (const T*)a.k + b * a.ks.b + hh * a.ks.h;
  const T* vg = (const T*)a.v + b * a.vs.b + hh * a.vs.h;
  const float* wg = a.lw + b * a.ws.b + hh * a.ws.h;
  T* og = (T*)a.o + ((size_t)b * S * a.H + hh) * hs;
  const size_t orow = (size_t)a.H * hs;
  for (int i = tid; i < hs * hs; i += WIT_THREADS)
    h[i] = a.h0[(size_t)bh * hs * hs + i];
  for (int i = tid; i < hs; i += WIT_THREADS) us[i] = u_at(a, hh, i);

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk;
    __syncthreads();   // the previous chunk's tiles are no longer read
    for (int i = tid; i < chunk * hs; i += WIT_THREADS) {
      const int t = i / hs, ch = i - t * hs;
      const bool in = t0 + t < S;
      const long long p = t0 + t;
      rs[t * P + ch] = in ? to_f(rg[p * a.rs.s + ch]) : 0.f;
      ks[t * P + ch] = in ? to_f(kg[p * a.ks.s + ch]) : 0.f;
      vs[t * P + ch] = in ? to_f(vg[p * a.vs.s + ch]) : 0.f;
      Ls[t * P + ch] = in ? wg[p * a.ws.s + ch] : 0.f;
    }
    __syncthreads();
    // cumulative log decay along the chunk, one channel per thread
    for (int ch = tid; ch < hs; ch += WIT_THREADS) {
      float acc = 0.f;
      for (int t = 0; t < chunk; ++t) {
        const float w = Ls[t * P + ch];
        acc += w;
        Ls[t * P + ch] = acc;
        Lx[t * P + ch] = acc - w;
      }
    }
    __syncthreads();
    // intra-chunk scores (strictly lower triangular) and the bonus
    for (int i = tid; i < chunk * chunk; i += WIT_THREADS) {
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
    for (int t = tid; t < chunk; t += WIT_THREADS) {
      float acc = 0.f;
      for (int ch = 0; ch < hs; ++ch)
        acc += rs[t * P + ch] * us[ch] * ks[t * P + ch];
      dg[t] = acc;
    }
    __syncthreads();
    // decayed r (for the state term) and decayed k (for the update)
    const float* Lend = Ls + (chunk - 1) * P;
    for (int i = tid; i < chunk * hs; i += WIT_THREADS) {
      const int t = i / hs, ch = i - t * hs;
      rs[t * P + ch] = rs[t * P + ch] * expf(Lx[t * P + ch]);
      ks[t * P + ch] = ks[t * P + ch] * expf(Lend[ch] - Ls[t * P + ch]);
    }
    __syncthreads();
    // outputs, against the state as it was at the chunk's start
    for (int i = tid; i < chunk * hs; i += WIT_THREADS) {
      const int t = i / hs, j = i - t * hs;
      if (t0 + t >= S) continue;
      float x = 0.f;
      for (int ch = 0; ch < hs; ++ch) x += rs[t * P + ch] * h[ch * hs + j];
      float y = 0.f;
      for (int s = 0; s < t; ++s) y += sc[t * chunk + s] * vs[s * P + j];
      float out = x + y;
      out = out + dg[t] * vs[t * P + j];
      og[(size_t)(t0 + t) * orow + j] = from_f<T>(out);
    }
    __syncthreads();
    // state update
    for (int i = tid; i < hs * hs; i += WIT_THREADS) {
      const int ch = i / hs, j = i - ch * hs;
      float acc = 0.f;
      for (int s = 0; s < chunk; ++s) acc += ks[s * P + ch] * vs[s * P + j];
      h[i] = expf(Lend[ch]) * h[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < hs * hs; i += WIT_THREADS)
    a.h_last[(size_t)bh * hs * hs + i] = h[i];
}

// ---------------------------------------------------------------------------
// the decode step (S = 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

// grid (B*H, hs/16), hs*4 threads: thread (i, q) owns h[i][c0+4q .. +3]
template <typename T>
__global__ void __launch_bounds__(512) wkv_decode(Args a) {
  __shared__ float red[16][16];
  const int hs = a.hs;
  const int bh = blockIdx.x, b = bh / a.H, hh = bh - b * a.H;
  const int c0 = blockIdx.y * 16;
  const int i = threadIdx.x >> 2, q = threadIdx.x & 3, j = c0 + 4 * q;
  const float ri = to_f(((const T*)a.r)[b * a.rs.b + hh * a.rs.h + i]);
  const float ki = to_f(((const T*)a.k)[b * a.ks.b + hh * a.ks.h + i]);
  const float wi = expf(a.lw[b * a.ws.b + hh * a.ws.h + i]);
  const float ui = u_at(a, hh, i);
  float vj[4], hv[4], op[4], hn[4];
  load4((const T*)a.v + b * a.vs.b + hh * a.vs.h + j, vj);
  const size_t at = ((size_t)bh * hs + i) * hs + j;
  load4(a.h0 + at, hv);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float kv = ki * vj[e];
    op[e] = ri * (hv[e] + ui * kv);
    hn[e] = wi * hv[e] + kv;
  }
  *reinterpret_cast<float4*>(a.h_last + at) =
      make_float4(hn[0], hn[1], hn[2], hn[3]);
  // sum over the rows: 8 a warp by shuffles, then the warps
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    op[e] += __shfl_xor_sync(0xffffffffu, op[e], 4);
    op[e] += __shfl_xor_sync(0xffffffffu, op[e], 8);
    op[e] += __shfl_xor_sync(0xffffffffu, op[e], 16);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * q + e] = op[e];
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float s = 0.f;
    for (int w = 0; w < hs / 8; ++w) s += red[w][threadIdx.x];
    ((T*)a.o)[(size_t)bh * hs + c0 + threadIdx.x] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------------
// the tensor-core chunk kernel (bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-filled where !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int at,
                                            float x, float y) {
  uint32_t h, l;
  split2(x, y, h, l);
  *reinterpret_cast<uint32_t*>(hi + at) = h;
  *reinterpret_cast<uint32_t*>(lo + at) = l;
}

// N (2 or 4) consecutive values from shared memory in one load
template <int N>
__device__ __forceinline__ void ld_bf16(const bf16* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 values");
  uint32_t w[N / 2];
  if constexpr (N == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x;
    w[1] = q.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 values");
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
}

// Shared memory of wkv_chunk_mma<HS, LC>. bf16 tiles have rows of HS + 8
// values (144 bytes at HS 64), so the eight rows an ldmatrix phase reads
// fall in eight different 16-byte bank groups.
template <int HS, int LC>
struct Smem {
  static constexpr int RS = HS + 8;   // bf16 row stride
  static constexpr int WS = HS + 4;   // fp32 row stride of w
  static constexpr int SS = LC + 4;   // fp32 row stride of the scores
  static constexpr int SX = 16 + 4;   // of the off-diagonal block's half
  // a load buffer: r, k, v (bf16) and lw -> w (fp32), as loaded
  static constexpr int LOAD = 3 * LC * RS * 2 + LC * WS * 4;
  // a stage, prep -> chain: r~ hi/lo, k~ hi/lo, v (bf16), scores, the
  // off-diagonal block's second half, exp(L_end)
  static constexpr int STAGE =
      5 * LC * RS * 2 + LC * SS * 4 + 16 * SX * 4 + HS * 4;
  // the off-diagonal factors, r^ and k^ hi/lo (two sub-chunks only)
  static constexpr int FAC = LC == 32 ? 4 * 16 * RS * 2 : 0;
  // the quarters' products of w, a float2 a channel pair
  static constexpr int QPROD = 4 * 32 * 8;
  static constexpr int BYTES = 2 * LOAD + 2 * STAGE + FAC + QPROD;
};

template <int HS, int LC>
struct Stage {
  bf16 *rh, *rl, *kh, *kl, *v;
  float *sc, *sx, *dec;
  __device__ __forceinline__ Stage(unsigned char* p) {
    constexpr int T = LC * Smem<HS, LC>::RS;
    rh = (bf16*)p;
    rl = rh + T;
    kh = rl + T;
    kl = kh + T;
    v = kl + T;
    sc = (float*)(v + T);
    sx = sc + LC * Smem<HS, LC>::SS;
    dec = sx + 16 * Smem<HS, LC>::SX;
  }
};

template <int HS, int LC>
struct Load {
  bf16 *r, *k, *v;
  float* w;
  __device__ __forceinline__ Load(unsigned char* p) {
    constexpr int T = LC * Smem<HS, LC>::RS;
    r = (bf16*)p;
    k = r + T;
    v = k + T;
    w = (float*)(v + T);
  }
};

// One round of a sum over lanes: each lane keeps half of its VH * 2
// values (the upper half where its lane bit BIT is set), adding the
// partner's other half.
template <int VH, int BIT>
__device__ __forceinline__ void sum_round(float (&acc)[16], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int x = 0; x < VH; ++x) {
    const float mine = up ? acc[VH + x] : acc[x];
    const float other = up ? acc[x] : acc[VH + x];
    acc[x] = mine + __shfl_xor_sync(0xffffffffu, other, BIT);
  }
}

// The diagonal 16 x 16 blocks of the scores, pairwise, and the bonus on
// their diagonal, for warp `wi` of `nw`. A row lies on LPR lanes of
// HS / LPR channels each (LPR 16 at HS 64, 8 at HS 16), a unit is the
// warp's 32 / LPR consecutive rows of sub-chunk g; units of the first
// sub-chunk count up and those of the second down, and warp wi takes
// units wi, wi + nw, ..., so that with 8 warps each pairs a short walk
// with a long one. A lane holds rd = r[t] exp(L_excl[t] - L[s]) for its
// channels and walks s down from t - 1, the block's k and w rows
// broadcast from shared memory, only below the unit's last row (a
// warp-uniform test); the LPR lanes of a row then sum, each keeping
// 16 / LPR columns s.
template <int HS, int LC>
__device__ __forceinline__ void pairwise(const Load<HS, LC>& L,
                                         const Stage<HS, LC>& St,
                                         const float (&uu)[HS == 64 ? 4 : 2],
                                         int wi, int nw, int lane) {
  constexpr int RS = Smem<HS, LC>::RS, WS = Smem<HS, LC>::WS;
  constexpr int SS = Smem<HS, LC>::SS;
  constexpr int LPR = HS == 64 ? 16 : 8;      // lanes a row
  constexpr int CPL = HS / LPR;               // channels a lane
  constexpr int RPU = 32 / LPR;               // rows a unit
  constexpr int UPG = 16 / RPU;               // units a sub-chunk
  constexpr int KEEP = 16 / LPR;              // columns a lane keeps
  const int cl = lane % LPR, ch0 = cl * CPL;
  for (int u = wi; u < (LC / 16) * UPG; u += nw) {
    const int g = u < UPG ? 0 : 1, rr = u < UPG ? u : 2 * UPG - 1 - u;
    const int pt = RPU * rr + lane / LPR, t = 16 * g + pt;
    const int smax = RPU * (rr + 1) - 1;       // the unit's last row
    float rd[CPL], kt[CPL], acc[16];
    ld_bf16(L.r + t * RS + ch0, rd);
    ld_bf16(L.k + t * RS + ch0, kt);
    float bonus = 0.f;
#pragma unroll
    for (int x = 0; x < CPL; ++x) bonus += rd[x] * uu[x] * kt[x];
    const bf16* kb = L.k + 16 * g * RS + ch0;
    const float* wb = L.w + 16 * g * WS + ch0;
#pragma unroll
    for (int s = 15; s >= 0; --s) {
      acc[s] = s == pt ? bonus : 0.f;
      if (s < smax) {                            // warp-uniform
        float kk[CPL], ww[CPL];
        ld_bf16(kb + s * RS, kk);
        ld_f32(wb + s * WS, ww);
        float sum = 0.f;
#pragma unroll
        for (int x = 0; x < CPL; ++x) sum += rd[x] * kk[x];
        const bool below = s < pt;
        if (below) acc[s] = sum;
#pragma unroll
        for (int x = 0; x < CPL; ++x) rd[x] = below ? rd[x] * ww[x] : rd[x];
      }
    }
    if constexpr (LPR == 16) {
      sum_round<8, 8>(acc, lane);
      sum_round<4, 4>(acc, lane);
      sum_round<2, 2>(acc, lane);
      sum_round<1, 1>(acc, lane);
    } else {
      sum_round<8, 4>(acc, lane);
      sum_round<4, 2>(acc, lane);
      sum_round<2, 1>(acc, lane);
    }
#pragma unroll
    for (int x = 0; x < KEEP; ++x)
      St.sc[t * SS + 16 * g + KEEP * cl + x] = acc[x];
  }
}

// named barriers: 0 is __syncthreads
constexpr int BAR_PREP = 1, BAR_SCANNED = 2, BAR_FULL = 3;

template <int HS, int LC>
__global__ void __launch_bounds__(256, 2) wkv_chunk_mma(Args a) {
  using SM = Smem<HS, LC>;
  constexpr int RS = SM::RS, WS = SM::WS, SS = SM::SS, SX = SM::SX;
  constexpr int NSUB = LC / 16;       // sub-chunks of 16 steps
  constexpr int NQ = LC / 8;          // quarters of 8 steps (the scan)
  constexpr int KT = HS / 16;         // k-steps over the key channels i
  constexpr int NI = HS / 8;          // n8 tiles over i (state fragments)
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* const smem = mma_smem;
  unsigned char* const stage0 = smem + 2 * SM::LOAD;
  bf16* fac = (bf16*)(smem + 2 * SM::LOAD + 2 * SM::STAGE);
  bf16 *rfh = fac, *rfl = fac + 16 * RS, *kfh = fac + 32 * RS,
       *kfl = fac + 48 * RS;
  float2* qprod = (float2*)(smem + 2 * SM::LOAD + 2 * SM::STAGE + SM::FAC);

  constexpr int NCW = HS / 16;                 // chain warps
  constexpr int NTHREADS = 32 * (NCW + 4);
  const int bh = blockIdx.x, b = bh / a.H, hh = bh - b * a.H;
  const int S = a.S, n_chunks = (S + LC - 1) / LC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bf16* rg = (const bf16*)a.r + b * a.rs.b + hh * a.rs.h;
  const bf16* kg = (const bf16*)a.k + b * a.ks.b + hh * a.ks.h;
  const bf16* vg = (const bf16*)a.v + b * a.vs.b + hh * a.vs.h;
  const float* wg = a.lw + b * a.ws.b + hh * a.ws.h;

  // u for this lane's channels of the pairwise step
  constexpr int CPL = HS == 64 ? 4 : 2;
  float uu[CPL];
#pragma unroll
  for (int x = 0; x < CPL; ++x)
    uu[x] = u_at(a, hh, (lane % (HS / CPL)) * CPL + x);

  if (warp >= NCW) {
    // ================= prep warps: what does not read the state ==========
    const int p = threadIdx.x - 32 * NCW;      // 0 .. PREP-1
    const int pw = p >> 5;

    auto issue_loads = [&](int c, Load<HS, LC> L) {
      const int t0 = c * LC;
      constexpr int RC = HS / 8;               // 16-byte chunks of a bf16 row
      constexpr int WC = HS / 4;               // of an fp32 row
      constexpr int n = LC * (3 * RC + WC);
      for (int x = p; x < n; x += PREP) {
        int y = x;
        if (y < LC * RC) {
          const int t = y / RC, ch = y % RC;
          const bool in = t0 + t < S;
          cp_async16(smem_u32(L.r + t * RS + ch * 8),
                     in ? rg + (long long)(t0 + t) * a.rs.s + ch * 8 : rg, in);
          continue;
        }
        y -= LC * RC;
        if (y < LC * RC) {
          const int t = y / RC, ch = y % RC;
          const bool in = t0 + t < S;
          cp_async16(smem_u32(L.k + t * RS + ch * 8),
                     in ? kg + (long long)(t0 + t) * a.ks.s + ch * 8 : kg, in);
          continue;
        }
        y -= LC * RC;
        if (y < LC * WC) {
          const int t = y / WC, ch = y % WC;
          const bool in = t0 + t < S;
          cp_async16(smem_u32(L.w + t * WS + ch * 4),
                     in ? wg + (long long)(t0 + t) * a.ws.s + ch * 4 : wg, in);
          continue;
        }
        y -= LC * WC;
        const int t = y / RC, ch = y % RC;
        const bool in = t0 + t < S;
        cp_async16(smem_u32(L.v + t * RS + ch * 8),
                   in ? vg + (long long)(t0 + t) * a.vs.s + ch * 8 : vg, in);
      }
      cp_async_commit();
    };

    issue_loads(0, Load<HS, LC>(smem));
    for (int c = 0; c < n_chunks; ++c) {
      const int sb = c & 1;
      Load<HS, LC> L(smem + sb * SM::LOAD);
      Stage<HS, LC> St(stage0 + sb * SM::STAGE);
      cp_async_wait_all();
      bar_sync(BAR_PREP, PREP);
      if (c + 1 < n_chunks)
        issue_loads(c + 1, Load<HS, LC>(smem + (sb ^ 1) * SM::LOAD));

      // -- decays: warp q takes quarter q (8 steps; sub-chunk q / 2, half
      //    q % 2), lane cp a channel pair, so that a warp reads and writes
      //    one row at a time, contiguously. The quarters' products meet in
      //    shared memory.
      const int q = pw, cp = lane, i0 = 2 * cp;
      const bool scan = q < NQ && cp < HS / 2;
      float2 w[8];
      float2 Q = make_float2(1.f, 1.f);
      if (scan) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float2* at = reinterpret_cast<float2*>(L.w + (8 * q + t) * WS + i0);
          const float2 l = *at;
          w[t] = make_float2(expf(l.x), expf(l.y));
          *at = w[t];                           // the pairwise step reads w
          Q.x *= w[t].x;
          Q.y *= w[t].y;
        }
        qprod[q * 32 + cp] = Q;
      }
      {
        // v to the stage: the load buffer is reloaded before the chain is
        // done with this chunk
        constexpr int VC = HS / 8;
        for (int x = p; x < LC * VC; x += PREP) {
          const int t = x / VC, ch = x % VC;
          *reinterpret_cast<uint4*>(St.v + t * RS + ch * 8) =
              *reinterpret_cast<const uint4*>(L.v + t * RS + ch * 8);
        }
      }
      bar_sync(BAR_PREP, PREP);
      if (scan) {
        const int g = q >> 1, half = q & 1;
        auto mul = [](float2 a, float2 b) {
          return make_float2(a.x * b.x, a.y * b.y);
        };
        const float2 one = make_float2(1.f, 1.f);
        const float2 Qo = qprod[(q ^ 1) * 32 + cp];   // the quarter beside
        const float2 Wg = half ? mul(Qo, Q) : mul(Q, Qo);
        const float2 Wo = NSUB == 2 ? mul(qprod[(2 - 2 * g) * 32 + cp],
                                          qprod[(3 - 2 * g) * 32 + cp])
                                    : one;       // the other sub-chunk
        // exp(L_excl[t] - L[16 g - 1]) = (the quarter before, in the same
        // sub-chunk) * prefix; exp(L_excl[t]) adds the sub-chunk before
        const float2 sub_before = g ? Wo : one;
        float2 loc = half ? Qo : one;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int row = 8 * q + t;
          const float2 r2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(L.r + row * RS + i0));
          store_split(St.rh, St.rl, row * RS + i0,
                      r2.x * sub_before.x * loc.x, r2.y * sub_before.y * loc.y);
          if (NSUB == 2 && g == 1)   // r^ = r exp(L_excl[t] - L[15])
            store_split(rfh, rfl, (row - 16) * RS + i0, r2.x * loc.x,
                        r2.y * loc.y);
          loc = mul(loc, w[t]);
        }
        // exp(L[16 g + 15] - L[s]) = suffix * (the quarter after, in the
        // same sub-chunk); exp(L_end - L[s]) adds the sub-chunk after
        const float2 sub_after = (NSUB == 2 && g == 0) ? Wo : one;
        float2 suf = half ? one : Qo;
#pragma unroll
        for (int t = 7; t >= 0; --t) {
          const int row = 8 * q + t;
          const float2 k2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(L.k + row * RS + i0));
          store_split(St.kh, St.kl, row * RS + i0, k2.x * suf.x * sub_after.x,
                      k2.y * suf.y * sub_after.y);
          if (NSUB == 2 && g == 0)   // k^ = k exp(L[15] - L[s])
            store_split(kfh, kfl, row * RS + i0, k2.x * suf.x, k2.y * suf.y);
          suf = mul(suf, w[t]);
        }
        if (q == 0)   // exp(L_end)
          *reinterpret_cast<float2*>(St.dec + i0) =
              NSUB == 2 ? mul(Wg, Wo) : Wg;
      }

      // the chain warps, done with chunk c - 1, take their share of the
      // pairwise step
      bar_sync(BAR_SCANNED, NTHREADS);
      pairwise(L, St, uu, pw, NCW + 4, lane);

      // -- the off-diagonal block on the tensor cores: warp pw takes the n8
      //    tile pw % 2 (8 columns s) over half the key channels (all of
      //    them at hs 16); the two halves land in two tiles the chain adds
      if (NSUB == 2 && (KT > 1 || pw < 2)) {
        constexpr int KH = KT > 1 ? KT / 2 : KT;
        const int nt = pw & 1, k0 = KT > 1 ? (pw >> 1) * KH : 0;
        float cacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kq = 0; kq < KH; ++kq) {
          const int kk = k0 + kq;
          uint32_t ah[4], al[4], bb[4];
          const int ar = lane & 15, ac = 16 * kk + 8 * (lane >> 4);
          ldsm_x4(ah, smem_u32(rfh + ar * RS + ac));
          ldsm_x4(al, smem_u32(rfl + ar * RS + ac));
          // matrices: k^ hi (s, i), (s, i+8), then k^ lo the same
          const int qm = lane >> 3;
          const bf16* kt = qm < 2 ? kfh : kfl;
          ldsm_x4(bb, smem_u32(kt + (8 * nt + (lane & 7)) * RS + 16 * kk +
                               8 * (qm & 1)));
          mma(cacc, ah, bb[0], bb[1]);
          mma(cacc, al, bb[0], bb[1]);
          mma(cacc, ah, bb[2], bb[3]);
        }
        float* dst = pw < 2 ? St.sc + 16 * SS : St.sx;
        const int ds = pw < 2 ? SS : SX;
        const int row = lane >> 2, col = 8 * nt + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dst + row * ds + col) =
            make_float2(cacc[0], cacc[1]);
        *reinterpret_cast<float2*>(dst + (row + 8) * ds + col) =
            make_float2(cacc[2], cacc[3]);
      }
      bar_sync(BAR_FULL, NTHREADS);
    }
    return;
  }

  // =================== chain warps: the state and o ========================
  const int jw = 16 * warp;                  // the warp's columns, in-block
  const size_t hbase = (size_t)bh * HS * HS;
  // h^T[j][i] as accumulator fragments: hf[ni][e] holds
  // j = jw + lane/4 + 8*(e/2), i = 8*ni + 2*(lane%4) + e%2
  float hf[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jw + (lane >> 2) + 8 * (e >> 1);
      const int i = 8 * ni + 2 * (lane & 3) + (e & 1);
      hf[ni][e] = a.h0[hbase + (size_t)i * HS + j];
    }
  bf16* og = (bf16*)a.o + ((size_t)b * S * a.H + hh) * HS + jw;
  const size_t orow = (size_t)a.H * HS;

  for (int c = 0; c < n_chunks; ++c) {
    const int sb = c & 1, t0 = c * LC;
    Stage<HS, LC> St(stage0 + sb * SM::STAGE);
    bar_sync(BAR_SCANNED, NTHREADS);
    pairwise(Load<HS, LC>(smem + sb * SM::LOAD), St, uu, 4 + warp, NCW + 4,
             lane);
    bar_sync(BAR_FULL, NTHREADS);

    float oacc[NSUB][2][4];
#pragma unroll
    for (int m = 0; m < NSUB; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[m][n][e] = 0.f;

    // o = scores @ v (the bonus on the scores' diagonal); causal, so the
    // first m-tile takes only the first k-step
#pragma unroll
    for (int ks = 0; ks < NSUB; ++ks) {
      uint32_t vb[4];   // n-tile 0: b0, b1; n-tile 1: b0, b1
      {
        const int q = lane >> 3;
        const int s = 16 * ks + 8 * (q & 1) + (lane & 7);
        ldsm_x4_t(vb, smem_u32(St.v + s * RS + jw + 8 * (q >> 1)));
      }
#pragma unroll
      for (int m = ks; m < NSUB; ++m) {
        uint32_t ah[4], al[4];
        const int r0 = 16 * m + (lane >> 2), c0 = 16 * ks + 2 * (lane & 3);
        const float* sc = St.sc;
        float2 x0 = *reinterpret_cast<const float2*>(sc + r0 * SS + c0);
        float2 x1 = *reinterpret_cast<const float2*>(sc + (r0 + 8) * SS + c0);
        float2 x2 = *reinterpret_cast<const float2*>(sc + r0 * SS + c0 + 8);
        float2 x3 =
            *reinterpret_cast<const float2*>(sc + (r0 + 8) * SS + c0 + 8);
        if (KT > 1 && m == 1 && ks == 0) {
          // the off-diagonal block: its second half of the key channels
          const float* sx = St.sx + (r0 - 16) * SX + c0;
          const float2 y0 = *reinterpret_cast<const float2*>(sx);
          const float2 y1 = *reinterpret_cast<const float2*>(sx + 8 * SX);
          const float2 y2 = *reinterpret_cast<const float2*>(sx + 8);
          const float2 y3 = *reinterpret_cast<const float2*>(sx + 8 * SX + 8);
          x0 = make_float2(x0.x + y0.x, x0.y + y0.y);
          x1 = make_float2(x1.x + y1.x, x1.y + y1.y);
          x2 = make_float2(x2.x + y2.x, x2.y + y2.y);
          x3 = make_float2(x3.x + y3.x, x3.y + y3.y);
        }
        split2(x0.x, x0.y, ah[0], al[0]);
        split2(x1.x, x1.y, ah[1], al[1]);
        split2(x2.x, x2.y, ah[2], al[2]);
        split2(x3.x, x3.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(oacc[m][n], ah, vb[2 * n], vb[2 * n + 1]);
          mma(oacc[m][n], al, vb[2 * n], vb[2 * n + 1]);
        }
      }
    }

    // o += r~ @ h: h's B fragments straight from the state's registers
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t bh_[2][2], bl_[2][2];   // [n-tile][b0, b1]
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        split2(hf[2 * kk][2 * n], hf[2 * kk][2 * n + 1], bh_[n][0],
               bl_[n][0]);
        split2(hf[2 * kk + 1][2 * n], hf[2 * kk + 1][2 * n + 1], bh_[n][1],
               bl_[n][1]);
      }
#pragma unroll
      for (int m = 0; m < NSUB; ++m) {
        uint32_t ah[4], al[4];
        const int ar = 16 * m + (lane & 15), ac = 16 * kk + 8 * (lane >> 4);
        ldsm_x4(ah, smem_u32(St.rh + ar * RS + ac));
        ldsm_x4(al, smem_u32(St.rl + ar * RS + ac));
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(oacc[m][n], ah, bh_[n][0], bh_[n][1]);
          mma(oacc[m][n], al, bh_[n][0], bh_[n][1]);
          mma(oacc[m][n], ah, bl_[n][0], bl_[n][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NSUB; ++m)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = 16 * m + (lane >> 2) + 8 * e2;
        if (t0 + t < S) {
          bf16* row = og + (size_t)(t0 + t) * orow + 2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
                __floats2bfloat162_rn(oacc[m][n][2 * e2],
                                      oacc[m][n][2 * e2 + 1]);
        }
      }

    // h^T = h^T * exp(L_end)[i] + v^T k~
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float2 d = *reinterpret_cast<const float2*>(
          St.dec + 8 * ni + 2 * (lane & 3));
      hf[ni][0] *= d.x;
      hf[ni][1] *= d.y;
      hf[ni][2] *= d.x;
      hf[ni][3] *= d.y;
    }
#pragma unroll
    for (int ks = 0; ks < NSUB; ++ks) {
      uint32_t av[4];
      {
        const int q = lane >> 3;
        const int s = 16 * ks + 8 * (q >> 1) + (lane & 7);
        ldsm_x4_t(av, smem_u32(St.v + s * RS + jw + 8 * (q & 1)));
      }
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) {
        uint32_t kb[4], kl[4];
        const int q = lane >> 3;
        const int s = 16 * ks + 8 * (q & 1) + (lane & 7);
        const int i = 16 * np + 8 * (q >> 1);
        ldsm_x4_t(kb, smem_u32(St.kh + s * RS + i));
        ldsm_x4_t(kl, smem_u32(St.kl + s * RS + i));
        mma(hf[2 * np], av, kb[0], kb[1]);
        mma(hf[2 * np], av, kl[0], kl[1]);
        mma(hf[2 * np + 1], av, kb[2], kb[3]);
        mma(hf[2 * np + 1], av, kl[2], kl[3]);
      }
    }
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jw + (lane >> 2) + 8 * (e >> 1);
      const int i = 8 * ni + 2 * (lane & 3) + (e & 1);
      a.h_last[hbase + (size_t)i * HS + j] = hf[ni][e];
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per kernel and device, not per launch
template <auto K>
int set_smem_once(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && done[dev]) return 0;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64) done[dev] = true;
  return 0;
}

template <int HS, int LC>
int launch_mma(const Args& a, cudaStream_t st) {
  constexpr int bytes = Smem<HS, LC>::BYTES;
  const int rc = set_smem_once<&wkv_chunk_mma<HS, LC>>(bytes);
  if (rc) return rc;
  wkv_chunk_mma<HS, LC><<<a.B * a.H, 32 * (HS / 16 + 4), bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// the witness's shared memory at its largest (hs 128, chunk 32)
constexpr int WIT_MAX_SMEM =
    sizeof(float) * (128 * 128 + 5 * 32 * 129 + 32 * 32 + 32 + 128);

template <typename T>
int launch_witness(const Args& a, cudaStream_t st) {
  const int rc = set_smem_once<&wkv_witness<T>>(WIT_MAX_SMEM);
  if (rc) return rc;
  const int hs = a.hs, ch = min(a.chunk, a.S);
  const size_t smem = sizeof(float) * ((size_t)hs * hs + 5 * ch * (hs + 1) +
                                       ch * ch + ch + hs);
  wkv_witness<T><<<a.B * a.H, WIT_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const Args& a, cudaStream_t st) {
  wkv_decode<T><<<dim3(a.B * a.H, a.hs / 16), a.hs * 4, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v (B, S, H, hs) in dtype (0 = float32, 1 = bfloat16) and lw
// (B, S, H, hs) fp32, each with element strides (batch, position, head)
// and a contiguous last axis; u (H, hs), bf16 if u_bf16 else fp32; h0 and
// h_last (B, H, hs, hs) fp32 and o (B, S, H, hs) in dtype, contiguous.
// hs in {16, 64, 128}, chunk in {16, 32}. route 0 is the path's kernel
// (the decode kernel at S = 1, else the tensor-core kernel for bf16 at hs
// 16 and 64 and the CUDA-core one for fp32 and at hs 128); route 1 the
// CUDA-core witness at any S.
// Returns BAD_ARGS (-1) for arguments outside these,
// cudaErrorMisalignedAddress where a row does not start 16 bytes aligned,
// else the launch's error.
extern "C" int rwkv6_wkv_fwd(
    const void* r, const void* k, const void* v, const float* lw,
    const void* u, const float* h0, void* o, float* h_last, int B, int S,
    int H, int hs, int chunk, long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long w_sb, long long w_ss,
    long long w_sh, int dtype, int u_bf16, int route, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (hs != 16 && hs != 64 && hs != 128) ||
      (chunk != 16 && chunk != 32) || (dtype != 0 && dtype != 1) ||
      (route != 0 && route != 1))
    return BAD_ARGS;
  const long long es = dtype == 0 ? 4 : 2;
  const long long rows[9] = {r_sb, r_ss, r_sh, k_sb, k_ss,
                             k_sh, v_sb, v_ss, v_sh};
  long long bad = (long long)(((uintptr_t)r | (uintptr_t)k | (uintptr_t)v |
                               (uintptr_t)lw | (uintptr_t)h0 |
                               (uintptr_t)h_last | (uintptr_t)o) & 15u);
  for (int i = 0; i < 9; ++i) bad |= (rows[i] * es) & 15;
  bad |= ((w_sb | w_ss | w_sh) * 4) & 15;
  if (bad) return (int)cudaErrorMisalignedAddress;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.lw = lw;
  a.u = u;
  a.h0 = h0;
  a.o = o;
  a.h_last = h_last;
  a.B = B;
  a.S = S;
  a.H = H;
  a.hs = hs;
  a.chunk = chunk;
  a.rs = Strides{r_sb, r_ss, r_sh};
  a.ks = Strides{k_sb, k_ss, k_sh};
  a.vs = Strides{v_sb, v_ss, v_sh};
  a.ws = Strides{w_sb, w_ss, w_sh};
  a.u_bf16 = u_bf16 ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1)
    return dtype == 0 ? launch_witness<float>(a, st)
                      : launch_witness<bf16>(a, st);
  if (S == 1)
    return dtype == 0 ? launch_decode<float>(a, st)
                      : launch_decode<bf16>(a, st);
  if (dtype == 0) return launch_witness<float>(a, st);
  if (hs == 128) return launch_witness<bf16>(a, st);
  if (hs == 64)
    return chunk == 32 ? launch_mma<64, 32>(a, st) : launch_mma<64, 16>(a, st);
  return chunk == 32 ? launch_mma<16, 32>(a, st) : launch_mma<16, 16>(a, st);
}
