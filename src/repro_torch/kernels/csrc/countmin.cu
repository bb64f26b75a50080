// Count-Min sketch kernels (sm_90a): the per-depth histogram of hashed
// ids, and the add-then-query of a batch against the updated table.
//
// countmin_add replaces the JAX package's Pallas kernel
// kernels/countmin.py::countmin_update (_cms_kernel) and, with
// countmin_query, ::countmin_update_query (_cms_uq_kernel). The TPU has no
// scatter-add, so its kernels build a (block, width) one-hot matrix per
// depth and sum it; the fused one also keeps its counts in fp32, exact only
// below 2^24. Hopper has integer atomics in shared memory and in L2, so
// here every id adds one to its cell with an int32 atomic: counts are
// exact int32 at any size, and the result is bitwise the same in any
// order, because integer adds commute.
//
// The hash is jnp's: id * a + b wraps in int32 (computed in uint32 and
// cast back), and jnp's % floors where C truncates, so the remainder mod
// 2^31 - 1 is lifted into [0, P) before slot = h % width.
//
// What bounds it: bytes (ids read, the table read and written once) for a
// uniform stream. A skewed stream puts many ids on one cell, and atomics on
// one address serialise in L2; lanes of a warp holding the same slot
// (__match_any_sync) add their count once, through their leader.
//
// countmin_add: grid (blocks, depth). Where a depth row fits shared memory
// (width <= kMaxSmemWidth), each block counts its share of the ids into a
// private copy of the row and then adds the row's nonzero cells into the
// table; otherwise blocks add straight into the table in device memory.
// countmin_query: one thread per id takes the min over depths of its
// cells. The update-then-query is two launches on the stream, so every
// add has landed before any gather.

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kP = 2147483647;
constexpr int kThreads = 256;
constexpr int kIdsPerBlock = 4096;      // least ids per block of the smem path
constexpr int kMaxSmemWidth = 49152;    // int32 cells: 192 KiB
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int cms_slot(int id, int a, int b, int width) {
  const unsigned hu = (unsigned)id * (unsigned)a + (unsigned)b;
  int h = ((int)hu) % kP;
  if (h < 0) h += kP;
  return h % width;
}

// Every lane of the warp calls this together. Lanes whose valid slot is
// equal add their number once, through the lowest of them.
__device__ __forceinline__ void add_warp(int* row, int slot, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? slot : -1);
  const int lane = threadIdx.x & 31;
  if (valid && lane == __ffs(peers) - 1) atomicAdd(row + slot, __popc(peers));
}

__global__ void cms_add_smem(const int* __restrict__ ids, long long n,
                             const int* __restrict__ seeds, int width,
                             int* __restrict__ table, long long per_block) {
  extern __shared__ int row[];
  const int d = blockIdx.y;
  const int a = seeds[2 * d], b = seeds[2 * d + 1];
  for (int j = threadIdx.x; j < width; j += blockDim.x) row[j] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = min(n, lo + per_block);
  // the base is the same for the whole block, so every warp takes every trip
  for (long long base = lo; base < hi; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const bool valid = i < hi;
    add_warp(row, valid ? cms_slot(ids[i], a, b, width) : 0, valid);
  }
  __syncthreads();
  int* out = table + (long long)d * width;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int v = row[j];
    if (v) atomicAdd(out + j, v);
  }
}

__global__ void cms_add_global(const int* __restrict__ ids, long long n,
                               const int* __restrict__ seeds, int width,
                               int* __restrict__ table) {
  const int d = blockIdx.y;
  const int a = seeds[2 * d], b = seeds[2 * d + 1];
  int* row = table + (long long)d * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    add_warp(row, valid ? cms_slot(ids[i], a, b, width) : 0, valid);
  }
}

__global__ void cms_query(const int* __restrict__ ids, long long n,
                          const int* __restrict__ seeds, int depth, int width,
                          const int* __restrict__ table,
                          int* __restrict__ est) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int id = ids[i];
    int m = INT_MAX;
    for (int d = 0; d < depth; ++d) {
      const int s = cms_slot(id, seeds[2 * d], seeds[2 * d + 1], width);
      m = min(m, table[(long long)d * width + s]);
    }
    est[i] = m;
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

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// Adds the counts of ids (n,) int32 into table (depth, width) int32, in
// place; seeds (depth, 2) int32 holds each depth's (a, b).
extern "C" int countmin_add(const int* ids, long long n, const int* seeds,
                            int depth, int width, int* table, void* stream) {
  if (n <= 0) return 0;
  if (depth <= 0 || width <= 0 || depth > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cap = ceil_div(4LL * sm_count(), depth);
  if (width <= kMaxSmemWidth) {
    const size_t smem = (size_t)width * sizeof(int);
    if (smem > (size_t)kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          cms_add_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // enough ids per block that its flush of the row stays small
    long long blocks = ceil_div(n, kIdsPerBlock);
    blocks = std::min(blocks, ceil_div(n, width));
    blocks = std::max(1LL, std::min(blocks, cap));
    const long long per_block = ceil_div(n, blocks);
    blocks = ceil_div(n, per_block);
    cms_add_smem<<<dim3((unsigned)blocks, depth), kThreads, smem, s>>>(
        ids, n, seeds, width, table, per_block);
  } else {
    const long long blocks =
        std::max(1LL, std::min(ceil_div(n, kThreads), 2 * cap));
    cms_add_global<<<dim3((unsigned)blocks, depth), kThreads, 0, s>>>(
        ids, n, seeds, width, table);
  }
  return (int)cudaGetLastError();
}

// est[i] = min over depths of table[d, slot_d(ids[i])].
extern "C" int countmin_query(const int* ids, long long n, const int* seeds,
                              int depth, int width, const int* table, int* est,
                              void* stream) {
  if (n <= 0) return 0;
  if (depth <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks =
      std::max(1LL, std::min(ceil_div(n, kThreads), 16LL * sm_count()));
  cms_query<<<(unsigned)blocks, kThreads, 0, s>>>(ids, n, seeds, depth, width,
                                                  table, est);
  return (int)cudaGetLastError();
}
