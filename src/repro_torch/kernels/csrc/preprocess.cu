// Streaming-preprocess kernels (sm_90a): signed feature hashing and the
// fused impute + Welford merge + normalize.
//
// hash_features replaces the JAX package's Pallas kernel
// kernels/preprocess.py::fused_hash_features (_hash_kernel). It is bound
// by the bytes of the dense (n, dim) output it writes. The TPU kernel
// builds a one-hot per feature because the TPU has no scatter; here one
// thread owns one row and adds its features into the row in feature
// order, with no atomics, so every per-row float sum is taken in the
// reference's order and the result is bitwise equal. The block first
// zeroes its rows with coalesced stores.
//   h = (id * a + 0x9E37) wraps in int32: it is computed in uint32 and
//   cast back. jnp's % and // floor where C truncates, so the remainder
//   mod 2^31-1 is lifted into [0, P) before slot = h % dim and the sign
//   bit (h / dim) & 1 are taken from the non-negative h.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHashRows = 128;
constexpr int kHashP = 2147483647;
constexpr unsigned kHashC = 0x9E37u;

__global__ void hash_kernel(const int* __restrict__ ids,
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

// Dense (n, dim) signed feature hashing of ids/vals (n, f); a = 2*seed+1.
extern "C" int hash_features(const int* ids, const float* vals, float* out,
                             int n, int f, int dim, unsigned a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + kHashRows - 1) / kHashRows;
  if (grid == 0) return 0;
  hash_kernel<<<grid, kHashRows, 0, s>>>(ids, vals, out, n, f, dim, a);
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
