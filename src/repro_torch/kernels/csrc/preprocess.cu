// Streaming-preprocess kernels (sm_90a): signed feature hashing and the
// fused impute + Welford merge + normalize.
//
// hash_features replaces the JAX package's Pallas kernel
// kernels/preprocess.py::fused_hash_features (_hash_kernel). It is bound
// by the bytes of the dense (n, dim) output it writes (256 MiB at the
// hashed job's 65,536 x 1,024, against 16 MiB of ids and vals read). The
// TPU kernel builds a one-hot per feature because the TPU has no
// scatter; here each output byte is written once, by coalesced 16-byte
// streaming stores (the output does not fit the 50 MB L2):
//   hash_staged: one warp a row at a time, its row staged in shared
//   memory (4 KiB at dim 1,024; kStageCells floats a block, so dim <=
//   kStageCells = 16,384). Its lanes load a pass of 32 of the row's ids
//   and vals (coalesced) and hash them; the lanes whose slots are equal
//   find each other with __match_any_sync, and the lowest of them reads
//   the cell, adds the group's values onto it in lane order, i.e. feature
//   order, and stores the sum once (one store a distinct slot, no
//   atomics). Passes of 32 repeat for f > 32. Then the warp writes the
//   row out whole and zeroes its stage behind the read. Every cell's sum
//   is ((+0.0 + c_first) + c_second) + ... in feature order, the
//   reference's (so a lone -0.0 comes out +0.0), and the result is
//   bitwise equal.
//   Measured (H100 80GB HBM3, 700 W; chip_smoke.py, CUDA-graph replays,
//   65,536 x 32 -> 1,024): 0.107 ms against 0.272 for hash_rowthread and
//   0.083 for torch.zeros of the same output. In development builds lane
//   0 scattering the pass alone was slower than the group sums; a grid of
//   only the blocks that fit at once, loading the next row's features
//   early, and a bulk (TMA) store of the row from two stage rows a warp
//   moved nothing beyond the spread between runs; a lane's eight shared
//   loads ahead of its eight stores is kept as the cheapest.
//   hash_rowthread (the first kernel, kept as the witness and as the
//   route for dim > kStageCells): one thread owns one row of a block of
//   128 and adds its features into the row in device memory in feature
//   order; the block first zeroes its 128 rows there. The output is
//   written twice and every access of the scatter is a sector of its own.
//   h = (id * a + 0x9E37) wraps in int32: it is computed in uint32 and
//   cast back. jnp's % and // floor where C truncates, so the remainder
//   mod 2^31-1 is lifted into [0, P) before slot = h % dim and the sign
//   bit (h / dim) & 1 are taken from the non-negative h (a mask and a
//   shift where dim is a power of two).
//
// normalize replaces kernels/preprocess.py::fused_normalize
// (_normalize_kernel). It is bound by bytes: x read once, y written once.
// The TPU kernel carried the batch sums across its sequential grid in
// VMEM; blocks here run in no order, so the reduction is three kernels,
// each deterministic (no float atomics):
//   1. moments_partial: each block sums x and x^2 (after NaN -> prior
//      mean) over a chunk of rows for 32 columns, 8 row lanes per column,
//      and writes one partial per (row chunk, column);
//   2. moments_finalize: one thread per column adds the partials in chunk
//      order and does the Welford merge from raw moments;
//   3. normalize_apply: y = (x - mean1) * rstd, elementwise.
// x is read twice (passes 1 and 3): 12 bytes moved per element where the
// bound counts 8.

#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHashRows = 128;
constexpr int kHashP = 2147483647;
constexpr unsigned kHashC = 0x9E37u;
constexpr int kStageCells = 16384;      // floats staged a block: 64 KiB
constexpr int kStageWarps = 8;
constexpr int kStageBlocksPerSm = 8;
constexpr int kCopyBatch = 8;   // float4 loads a lane makes before its stores
// dynamic shared memory a launch may take without opting in, beside
// hash_staged's 1 KiB of static peer values
constexpr size_t kDefaultDynamicSmem = 47 * 1024;

// h mod (2^31 - 1), floored, of the int32 h = id * a + 0x9E37: h, h + P or
// h + 2P (selects, where the witness divides).
__device__ __forceinline__ int hash_mod_p(const int id, const unsigned a) {
  const int h = (int)((unsigned)id * a + kHashC);
  if (h >= 0) return h == kHashP ? 0 : h;
  const int m = h + kHashP;             // in [-1, P - 1)
  return m < 0 ? m + kHashP : m;
}

__global__ void hash_rowthread(const int* __restrict__ ids,
                               const float* __restrict__ vals,
                               float* __restrict__ out, int n, int f, int dim,
                               unsigned a) {
  const long long row0 = (long long)blockIdx.x * kHashRows;
  const int rows = min(kHashRows, (int)(n - row0));
  float* base = out + row0 * dim;
  for (long long i = threadIdx.x; i < (long long)rows * dim; i += blockDim.x)
    base[i] = 0.0f;
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const long long row = row0 + threadIdx.x;
  float* o = out + row * dim;
  const int* id = ids + row * f;
  const float* v = vals + row * f;
  for (int j = 0; j < f; ++j) {
    const unsigned hu = (unsigned)id[j] * a + kHashC;
    int h = ((int)hu) % kHashP;
    if (h < 0) h += kHashP;
    const int slot = h % dim;
    const float c = ((h / dim) & 1) ? -v[j] : v[j];
    o[slot] = __fadd_rn(o[slot], c);
  }
}

// shift = log2(dim) where dim is a power of two, else -1; vec: dim % 4 == 0
// and out 16-byte aligned.
__global__ void __launch_bounds__(kStageWarps * 32)
hash_staged(const int* __restrict__ ids, const float* __restrict__ vals,
            float* __restrict__ out, int n, int f, int dim, unsigned a,
            int shift, bool vec) {
  extern __shared__ float4 stage4[];
  __shared__ float peer_val[kStageWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* row = reinterpret_cast<float*>(stage4) + (long long)warp * dim;
  float* pv = peer_val[warp];
  for (int j = lane; j < dim; j += 32) row[j] = 0.0f;
  __syncwarp();
  const long long step = (long long)gridDim.x * warps;
  for (long long r = (long long)blockIdx.x * warps + warp; r < n; r += step) {
    const int* id = ids + r * f;
    const float* v = vals + r * f;
    for (int p = 0; p < f; p += 32) {
      const bool valid = p + lane < f;
      int slot = -1;
      float c = 0.0f;
      if (valid) {
        const int h = hash_mod_p(__ldg(id + p + lane), a);
        const float x = __ldg(v + p + lane);
        const bool odd = shift >= 0 ? (h >> shift) & 1 : (h / dim) & 1;
        slot = shift >= 0 ? h & (dim - 1) : h % dim;
        c = odd ? -x : x;
      }
      // the lanes holding one slot; the lowest adds them in lane order
      const unsigned peers = __match_any_sync(0xffffffffu, slot);
      pv[lane] = c;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) {
        float s = row[slot];
        for (unsigned m = peers; m; m &= m - 1)
          s = __fadd_rn(s, pv[__ffs(m) - 1]);
        row[slot] = s;
      }
      __syncwarp();
    }
    // the row out, its stage zeroed behind it: each lane's reads first,
    // then its stores (eight 16-byte stores a lane at dim 1,024)
    float* o = out + r * dim;
    if (vec) {
      float4* row4 = reinterpret_cast<float4*>(row);
      float4* o4 = reinterpret_cast<float4*>(o);
      const int q_end = dim / 4;
      for (int q0 = lane; q0 < q_end; q0 += 32 * kCopyBatch) {
        float4 x[kCopyBatch];
#pragma unroll
        for (int k = 0; k < kCopyBatch; ++k)
          if (q0 + 32 * k < q_end) x[k] = row4[q0 + 32 * k];
#pragma unroll
        for (int k = 0; k < kCopyBatch; ++k)
          if (q0 + 32 * k < q_end) {
            row4[q0 + 32 * k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            __stcs(o4 + q0 + 32 * k, x[k]);
          }
      }
    } else {
      for (int j = lane; j < dim; j += 32) {
        const float x = row[j];
        row[j] = 0.0f;
        __stcs(o + j, x);
      }
    }
    __syncwarp();
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

constexpr int kCols = 32;       // columns per block (one warp wide)
constexpr int kLanes = 8;       // row lanes per column
constexpr int kChunk = 512;     // rows per block in pass 1

__global__ void moments_partial(const float* __restrict__ x,
                                const float* __restrict__ mean0, int n, int d,
                                int impute, float* __restrict__ s1p,
                                float* __restrict__ s2p) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kCols + tx;
  const int r0 = blockIdx.y * kChunk;
  const int r1 = min(n, r0 + kChunk);
  float s1 = 0.0f, s2 = 0.0f;
  if (c < d) {
    const float m = mean0[c];
    for (int r = r0 + ty; r < r1; r += kLanes) {
      float v = x[(long long)r * d + c];
      if (impute && isnan(v)) v = m;
      s1 = __fadd_rn(s1, v);
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
    }
  }
  __shared__ float sh1[kLanes][kCols + 1];
  __shared__ float sh2[kLanes][kCols + 1];
  sh1[ty][tx] = s1;
  sh2[ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < d) {
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < kLanes; ++k) {
      a = __fadd_rn(a, sh1[k][tx]);
      b = __fadd_rn(b, sh2[k][tx]);
    }
    s1p[(long long)blockIdx.y * d + c] = a;
    s2p[(long long)blockIdx.y * d + c] = b;
  }
}

__global__ void moments_finalize(const float* __restrict__ s1p,
                                 const float* __restrict__ s2p, int chunks,
                                 int d, int n, const float* __restrict__ n0p,
                                 const float* __restrict__ mean0,
                                 const float* __restrict__ m20,
                                 float* __restrict__ n1_out,
                                 float* __restrict__ mean1,
                                 float* __restrict__ m21,
                                 float* __restrict__ rstd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int b = 0; b < chunks; ++b) {
    s1 = __fadd_rn(s1, s1p[(long long)b * d + c]);
    s2 = __fadd_rn(s2, s2p[(long long)b * d + c]);
  }
  const float n0 = *n0p;
  const float nb = (float)n;
  const float mean_b = s1 / nb;
  // batch m2 from raw moments: sum(x^2) - nb * mean_b^2
  const float m2_b = fmaxf(s2 - nb * mean_b * mean_b, 0.0f);
  const float n1 = n0 + nb;
  const float delta = mean_b - mean0[c];
  const float denom = fmaxf(n1, 1.0f);
  const float mu = mean0[c] + delta * (nb / denom);
  const float m2 = m20[c] + m2_b + delta * delta * n0 * nb / denom;
  const float var = m2 / fmaxf(n1 - 1.0f, 1.0f);
  mean1[c] = mu;
  m21[c] = m2;
  rstd[c] = 1.0f / sqrtf(var + 1e-6f);
  if (c == 0) *n1_out = n1;
}

__global__ void normalize_apply(const float* __restrict__ x,
                                const float* __restrict__ mean0,
                                const float* __restrict__ mean1,
                                const float* __restrict__ rstd, long long total,
                                int d, int impute, float* __restrict__ y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % d);
    float v = x[i];
    if (impute && isnan(v)) v = mean0[c];
    y[i] = __fmul_rn(__fsub_rn(v, mean1[c]), rstd[c]);
  }
}

}  // namespace

// Dense (n, dim) signed feature hashing of ids/vals (n, f); a = 2*seed+1:
// hash_staged where a row fits the stage (dim <= kStageCells), else
// hash_rowthread.
extern "C" int hash_features(const int* ids, const float* vals, float* out,
                             int n, int f, int dim, unsigned a, void* stream) {
  if (n < 0 || f < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim > kStageCells) {
    hash_rowthread<<<(n + kHashRows - 1) / kHashRows, kHashRows, 0, s>>>(
        ids, vals, out, n, f, dim, a);
    return (int)cudaGetLastError();
  }
  const int warps = std::min(kStageWarps, kStageCells / dim);
  const int shift = (dim & (dim - 1)) ? -1 : __builtin_ctz((unsigned)dim);
  const bool vec = dim % 4 == 0 && (uintptr_t)out % 16 == 0;
  const size_t smem = (size_t)warps * dim * sizeof(float);
  if (smem > kDefaultDynamicSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        hash_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = std::min<long long>(
      (n + warps - 1) / warps, (long long)kStageBlocksPerSm * sm_count());
  hash_staged<<<(unsigned)blocks, warps * 32, smem, s>>>(
      ids, vals, out, n, f, dim, a, shift, vec);
  return (int)cudaGetLastError();
}

// The witness: hash_rowthread at any dim.
extern "C" int hash_features_rowthread(const int* ids, const float* vals,
                                       float* out, int n, int f, int dim,
                                       unsigned a, void* stream) {
  if (n < 0 || f < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hash_rowthread<<<(n + kHashRows - 1) / kHashRows, kHashRows, 0,
                   static_cast<cudaStream_t>(stream)>>>(ids, vals, out, n, f,
                                                        dim, a);
  return (int)cudaGetLastError();
}

// Number of row chunks pass 1 uses; the caller sizes the partials
// (2 * chunks * d floats) and the stats (d floats of rstd) with it.
extern "C" int normalize_chunks(int n) { return (n + kChunk - 1) / kChunk; }

// y (n, d), n1 (1), mean1 (d), m21 (d) from x (n, d) and the running state
// n0 (1), mean0 (d), m20 (d). scratch: 2 * chunks * d + d floats.
extern "C" int fused_normalize(const float* x, const float* n0,
                               const float* mean0, const float* m20, float* y,
                               float* n1, float* mean1, float* m21,
                               float* scratch, int n, int d, int impute,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = normalize_chunks(n);
  float* s1p = scratch;
  float* s2p = scratch + (long long)chunks * d;
  float* rstd = scratch + 2LL * chunks * d;
  if (chunks > 0) {
    dim3 grid1((d + kCols - 1) / kCols, chunks), block1(kCols, kLanes);
    moments_partial<<<grid1, block1, 0, s>>>(x, mean0, n, d, impute, s1p, s2p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  moments_finalize<<<(d + 127) / 128, 128, 0, s>>>(
      s1p, s2p, chunks, d, n, n0, mean0, m20, n1, mean1, m21, rstd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)n * d;
  if (total == 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  normalize_apply<<<(int)blocks, 256, 0, s>>>(x, mean0, mean1, rstd, total, d,
                                              impute, y);
  return (int)cudaGetLastError();
}
