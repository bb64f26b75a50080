// Mamba selective scan (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t,   y_t = h_t . C_t
// over (B, S, dI) inputs with N states per channel, fp32.
//
// Replaces the JAX package's Pallas kernel kernels/mamba_scan.py::
// mamba_scan_bd (_mamba_kernel). The TPU kernel walks its grid's chunk
// axis in order with the (bd, N) state in VMEM and forms (Lc, bd, N) tiles
// of exp(dt A) and dt x B per chunk. On Hopper the state is registers and
// nothing of size (S, dI, N) is ever formed.
//
// What bounds it: bytes (dt, x read and y written once: 12 bytes per
// (b, t, channel); 0.48 ms at jamba's prefill, B 2, S 4,096, dI 16,384),
// and beside them the N exps per (b, t, channel) on the special-function
// units (16 results a clock an SM: 2.1 G exps, ~0.57 ms at 1.755 GHz).
// mamba_scan_lanes, the kernel of the path:
//   * four lanes a channel (kLanes), each holding N / 4 states; a thread
//     is a lane of two neighbouring channels (kPair), so that the lane's
//     B_t and C_t, read from shared memory once a step, serve both. A
//     block of 64 channels is 128 threads; jamba's B 2 x 16,384 channels
//     give ~16 warps an SM, each thread with two independent chains. A
//     lane's A, h0 and h_last move as one float4 (N 16). y_t is the sum of
//     the lanes' partial dot products, taken by two xor shuffles in a fixed
//     order: (p0 + p1) + (p2 + p3); y is staged per tile and written out
//     as rows;
//   * A is scaled by log2(e) once at load, and each exponential is one
//     ex2.approx.ftz.f32 (expf is several FMA-pipe instructions around
//     the same MUFU op);
//   * dt and x for (kMaxTile steps x 64 channels) and B_t, C_t for the
//     tile's steps are staged in shared memory by cp.async (16 bytes a
//     copy where dI % 4 == 0 and the inputs are aligned, else 4), two
//     buffers deep, and a thread loads step t + 1's operands before it
//     computes step t, so the chain waits on neither.
//   The loop stops at S, so a ragged last tile leaves h_last exact, as the
//   TPU kernel's padding with dt = 0 does. Fused multiply-adds are
//   allowed: it is held to its plain version within a float tolerance.
//   Measured (H100 80GB HBM3, 700 W, jamba's prefill, development builds
//   timed in turns): one channel a thread (~31 warps an SM) took 1.12 ms,
//   and timing ablations of it each took off only 4-13% (the
//   exponentials 4%, B and C's loads 11%, the shuffles 13%): no single
//   unit bound it. Adding the lanes' sums in the tile's write-out in
//   place of the shuffles took 1.34 ms. Two channels a thread take 0.985
//   ms: 64 instructions a warp and step (16 channel-steps, 8 of them
//   MUFU), ~1.05 M issue cycles an SM, as many as the MUFU's 16 results
//   a clock need; it issues at ~58% of that rate (0.91 ms with the
//   exponentials taken out).
// mamba_scan_thread, the first kernel, kept as the witness: one thread
// owns one (batch, channel) with its N states and walks t in order; B_t
// and C_t per chunk in shared memory, dt and x read from device memory
// (at B 2, 128 blocks of 256 threads: ~8 warps an SM, too few to hide 16
// dependent expf and FMA a step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDefaultSmem = 48 * 1024;

template <int N>
__global__ void mamba_scan_thread(const float* __restrict__ dt,
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
int launch_thread(const float* dt, const float* x, const float* Bm, const float* Cm,
           const float* A, const float* h0, float* y, float* h_last, int B,
           int S, int dI, int chunk, int bd, cudaStream_t s) {
  const size_t smem = (size_t)2 * chunk * N * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_thread<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((dI + bd - 1) / bd, B);
  mamba_scan_thread<N><<<grid, bd, smem, s>>>(dt, x, Bm, Cm, A, h0, y,
                                              h_last, S, dI, chunk);
  return (int)cudaGetLastError();
}

constexpr int kLanes = 4;          // threads a channel
constexpr int kPair = 2;           // channels a thread
constexpr int kMaxChannels = 64;   // channels a block
constexpr int kMaxTile = 32;       // steps staged at a time
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src));
}

template <int N>
__host__ __device__ constexpr int lanes_buffer_floats() {
  return 2 * kMaxTile * kMaxChannels + 2 * kMaxTile * N;
}

// two buffers, then y of a tile (kMaxTile, kMaxChannels)
template <int N>
__host__ __device__ constexpr size_t lanes_smem_bytes() {
  return (2 * lanes_buffer_floats<N>() + kMaxTile * kMaxChannels) *
         sizeof(float);
}

// A block: chans channels (a multiple of 16, at most kMaxChannels) of one
// batch row; a thread is one of kLanes lanes of two neighbouring channels;
// tile steps (at most kMaxTile) staged at a time; vec: 16-byte copies and
// state accesses (dI % 4 == 0, every pointer 16-byte aligned).
// blocks an SM the registers are budgeted for: 4 at N <= 16 (at most 128
// registers a thread); at N 32 and 64 a lane's 8 or 16 states a channel
// (and their A, B and C) need more, so 2
template <int N>
__global__ void __launch_bounds__(kLanes * kMaxChannels / kPair,
                                  N <= 16 ? 4 : 2)
mamba_scan_lanes(const float* __restrict__ dt, const float* __restrict__ x,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ A, const float* __restrict__ h0,
                 float* __restrict__ y, float* __restrict__ h_last, int S,
                 int dI, int tile, int chans, bool vec) {
  constexpr int K = N / kLanes;                 // states a lane
  constexpr int kBuf = lanes_buffer_floats<N>();
  extern __shared__ float4 lanes_smem[];
  float* sm = reinterpret_cast<float*>(lanes_smem);
  float* sy = sm + 2 * kBuf;                    // (kMaxTile, kMaxChannels)
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * chans;
  const int cb = min(chans, dI - c0);           // this block's channels
  const int ch0 = threadIdx.x / kLanes * kPair, lane = threadIdx.x % kLanes;
  float a2[kPair][K], h[kPair][K];
#pragma unroll
  for (int m = 0; m < kPair; ++m) {
    const bool on = ch0 + m < cb;
    const long long sa = (long long)(c0 + ch0 + m) * N + lane * K;
    const long long st = (long long)b * dI * N + sa;
    if (K == 4 && on && vec) {
      const float4 a = *reinterpret_cast<const float4*>(A + sa);
      const float4 g = *reinterpret_cast<const float4*>(h0 + st);
      a2[m][0] = a.x, a2[m][1 % K] = a.y, a2[m][2 % K] = a.z,
      a2[m][3 % K] = a.w;
      h[m][0] = g.x, h[m][1 % K] = g.y, h[m][2 % K] = g.z, h[m][3 % K] = g.w;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a2[m][k] = on ? A[sa + k] : 0.0f;
        h[m][k] = on ? h0[st + k] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a2[m][k] *= kLog2e;
  }

  const long long row = (long long)b * S;       // (b, 0) in (B, S, .)
  const int w = vec ? 4 : 1;                    // floats a copy
  const int per_row = (cb + w - 1) / w;         // copies a row of dt or x
  const int per_bc = N / w;                     // copies a step of B or C
  auto load_tile = [&](int buf, int t0, int L) {
    float* sdt = sm + buf * kBuf;
    float* sx = sdt + kMaxTile * kMaxChannels;
    float* sB = sx + kMaxTile * kMaxChannels;
    float* sC = sB + kMaxTile * N;
    const int nrow = L * per_row;
    for (int i = threadIdx.x; i < 2 * nrow; i += blockDim.x) {
      const int which = i >= nrow, j = i - which * nrow;
      const int step = j / per_row, col = (j - step * per_row) * w;
      const long long g = (row + t0 + step) * dI + c0 + col;
      cp_async((which ? sx : sdt) + step * kMaxChannels + col,
               (which ? x : dt) + g, min(cb - col, w) * 4, vec);
    }
    const int nbc = L * per_bc;
    for (int i = threadIdx.x; i < 2 * nbc; i += blockDim.x) {
      const int which = i >= nbc, j = (i - which * nbc) * w;
      cp_async((which ? sC : sB) + j, (which ? Cm : Bm) + (row + t0) * N + j,
               w * 4, vec);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const int tiles = (S + tile - 1) / tile;
  if (tiles > 0) load_tile(0, 0, min(tile, S));
  for (int i = 0; i < tiles; ++i) {
    const int t0 = i * tile, L = min(tile, S - t0);
    if (i + 1 < tiles) {
      load_tile((i + 1) & 1, t0 + tile, min(tile, S - t0 - tile));
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* sdt = sm + (i & 1) * kBuf;
    const float* sx = sdt + kMaxTile * kMaxChannels;
    const float* sB = sx + kMaxTile * kMaxChannels;
    const float* sC = sB + kMaxTile * N;
    // a step's operands: dt and x of the two channels, the lane's B and C
    struct Ops {
      float2 d, x;
      float b[K], c[K];
    };
    auto operands = [&](int t) {
      Ops o;
      o.d = *reinterpret_cast<const float2*>(sdt + t * kMaxChannels + ch0);
      o.x = *reinterpret_cast<const float2*>(sx + t * kMaxChannels + ch0);
      if constexpr (K == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(sB + t * N + lane * K);
        const float4 c4 = *reinterpret_cast<const float4*>(sC + t * N + lane * K);
        o.b[0] = b4.x, o.b[1 % K] = b4.y, o.b[2 % K] = b4.z, o.b[3 % K] = b4.w;
        o.c[0] = c4.x, o.c[1 % K] = c4.y, o.c[2 % K] = c4.z, o.c[3 % K] = c4.w;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          o.b[k] = sB[t * N + lane * K + k];
          o.c[k] = sC[t * N + lane * K + k];
        }
      }
      return o;
    };
    Ops next = operands(0);
#pragma unroll 2
    for (int t = 0; t < L; ++t) {
      const Ops cur = next;
      next = operands(min(t + 1, L - 1));       // step t + 1's, early
      const float d[kPair] = {cur.d.x, cur.d.y};
      const float dx[kPair] = {cur.d.x * cur.x.x, cur.d.y * cur.x.y};
      float acc[kPair];
#pragma unroll
      for (int m = 0; m < kPair; ++m) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          h[m][k] = fmaf(ex2(d[m] * a2[m][k]), h[m][k], dx[m] * cur.b[k]);
        acc[m] = h[m][0] * cur.c[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc[m] = fmaf(h[m][k], cur.c[k], acc[m]);
      }
      // the four lanes' sums: (p0 + p1) + (p2 + p3) on every lane
#pragma unroll
      for (int m = 0; m < kPair; ++m)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 1);
#pragma unroll
      for (int m = 0; m < kPair; ++m)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], 2);
      if (lane == 0)
        *reinterpret_cast<float2*>(sy + t * kMaxChannels + ch0) =
            make_float2(acc[0], acc[1]);
    }
    __syncthreads();
    // y of the tile out, a row of cb channels a step
    const int nrow = L * per_row;
    for (int j = threadIdx.x; j < nrow; j += blockDim.x) {
      const int step = j / per_row, col = (j - step * per_row) * w;
      float* dst = y + (row + t0 + step) * dI + c0 + col;
      const float* src = sy + step * kMaxChannels + col;
      if (vec)
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      else
        *dst = *src;
    }
  }
#pragma unroll
  for (int m = 0; m < kPair; ++m) {
    if (ch0 + m >= cb) continue;
    const long long st = ((long long)b * dI + c0 + ch0 + m) * N + lane * K;
    if (K == 4 && vec) {
      *reinterpret_cast<float4*>(h_last + st) =
          make_float4(h[m][0], h[m][1 % K], h[m][2 % K], h[m][3 % K]);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) h_last[st + k] = h[m][k];
    }
  }
}

template <int N>
int launch_lanes(const float* dt, const float* x, const float* Bm,
                 const float* Cm, const float* A, const float* h0, float* y,
                 float* h_last, int B, int S, int dI, int tile, int chans,
                 bool vec, cudaStream_t s) {
  const size_t smem = lanes_smem_bytes<N>();
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_lanes<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((dI + chans - 1) / chans, B);
  mamba_scan_lanes<N><<<grid, kLanes * chans / kPair, smem, s>>>(
      dt, x, Bm, Cm, A, h0, y, h_last, S, dI, tile, chans, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x: (B, S, dI); Bm, Cm: (B, S, N); A: (dI, N); h0: (B, dI, N); all
// fp32 and contiguous. Writes y (B, S, dI) and h_last (B, dI, N). N is 4
// or 16, the configs' d_state, or 32 or 64, so that every N up to 64 runs
// (zero-padded by the Python wrapper); other N are refused.

// mamba_scan_lanes: tile steps staged at a time (1 to kMaxTile), chans
// channels a block (a multiple of 16, 16 to kMaxChannels).
extern "C" int mamba_scan(const float* dt, const float* x, const float* Bm,
                          const float* Cm, const float* A, const float* h0,
                          float* y, float* h_last, int B, int S, int dI,
                          int N, int tile, int chans, void* stream) {
  if (B < 1 || S < 0 || dI < 1 || tile < 1 || tile > kMaxTile ||
      chans < 16 || chans > kMaxChannels || chans % 16 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t any = (uintptr_t)dt | (uintptr_t)x | (uintptr_t)Bm |
                        (uintptr_t)Cm | (uintptr_t)A | (uintptr_t)h0 |
                        (uintptr_t)y | (uintptr_t)h_last;
  const bool vec = dI % 4 == 0 && any % 16 == 0;
  switch (N) {
    case 4:
      return launch_lanes<4>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, tile,
                             chans, vec, s);
    case 16:
      return launch_lanes<16>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, tile,
                              chans, vec, s);
    case 32:
      return launch_lanes<32>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, tile,
                              chans, vec, s);
    case 64:
      return launch_lanes<64>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, tile,
                              chans, vec, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The witness, mamba_scan_thread: bd threads a block (a multiple of 32, at
// most 1,024; at N 64 a thread's 128 states and A need bd <= 256); chunk
// steps of B and C staged at a time (2 * chunk * N floats of shared
// memory, within the block's 227 KB).
extern "C" int mamba_scan_witness(const float* dt, const float* x,
                                  const float* Bm, const float* Cm,
                                  const float* A, const float* h0, float* y,
                                  float* h_last, int B, int S, int dI, int N,
                                  int chunk, int bd, void* stream) {
  if (B < 1 || S < 0 || dI < 1 || N < 1 || chunk < 1 ||
      bd < 32 || bd > 1024 || bd % 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MAMBA_CASE(n) \
  case n:             \
    return launch_thread<n>(dt, x, Bm, Cm, A, h0, y, h_last, B, S, dI, chunk, \
                            bd, s);
  switch (N) {
    MAMBA_CASE(4) MAMBA_CASE(16) MAMBA_CASE(32) MAMBA_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAMBA_CASE
}
