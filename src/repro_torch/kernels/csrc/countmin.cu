// Count-Min sketch kernels (sm_90a): the per-depth histogram of hashed
// ids, and the add-then-query of a batch against the updated table.
//
// countmin_add replaces the JAX package's Pallas kernel
// kernels/countmin.py::countmin_update (_cms_kernel); countmin_update_query
// replaces ::countmin_update_query (_cms_uq_kernel). The TPU has no
// scatter-add, so its kernels build a (block, width) one-hot matrix per
// depth and sum it; the fused one also keeps its counts in fp32, exact only
// below 2^24. Hopper has integer atomics in shared memory and in L2, so
// here every id adds one to its cell with an int32 atomic: counts are
// exact int32 at any size, and the result is bitwise the same in any
// order, because integer adds commute.
//
// The hash is jnp's: id * a + b wraps in int32 (computed in uint32 and
// cast back), and jnp's % floors where C truncates, so the remainder mod
// 2^31 - 1 is lifted into [0, P) before slot = h % width (a mask where
// width is a power of two, as both of the path's widths are).
//
// What bounds it: bytes (ids read, the table read and written once) for a
// uniform stream. A skewed stream puts many ids on one cell, and atomics on
// one address serialise, in L2 above all: the summarization path's stream
// has a quarter of its ids on one id.
//
// One add serves both entries. Its C entry first fills the table it adds
// into, on the caller's stream: zeros (cudaMemsetAsync: the increment,
// countmin_update) or a copy of the caller's table (the sketch's own
// update, and the first half of countmin_update_query), so no separate
// zeros, increment and table + increment pass over the table remain.
//   1. uq_add reads each id once (16-byte loads) and adds it at every
//      depth (one atomic a lane: aggregating a warp's equal ids with
//      __match_any_sync cost more than the atomics it saved). Where all
//      depth rows fit shared memory (depth * width <= kMaxSmemWidth, 16 KiB
//      for the path's 4 x 1,024) a block counts into them and flushes their
//      nonzero cells; otherwise a block keeps the counts of the ids it
//      meets in a small shared table keyed by id (kCache entries, the
//      first id at each entry keeps it) and flushes those once, so the
//      stream's hot id costs each block one device-memory atomic a depth;
//      ids that find their entry taken add straight into device memory.
//   2. uq_query (countmin_update_query only, a second launch on the same
//      stream, so every add lands before any gather): one thread per 4 ids
//      takes the min over depths, from a copy of the table in shared
//      memory where it fits 48 KiB.
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py, CUDA-graph replays):
// on 1,048,576 Zipf ids the add-then-query takes 0.018 ms at width 1,024
// and 0.040 at 2^20, the increment (memset and add) 0.010 and 0.023,
// against 0.034 and 0.079 for the witness kernels.
// Warp aggregation and a remainder by division made the add slower;
// more loads in flight, more or fewer blocks and a per-warp register
// count of the hot id moved nothing.
//
// countmin_add_witness keeps the increment's first kernels, which the add
// replaced, as its witness on the card: grid (blocks, depth), so every id
// is read and hashed once a depth, the remainder by division, each warp's
// equal slots aggregated with __match_any_sync; a depth row in shared
// memory where it fits (width <= kMaxSmemWidth), else atomics straight
// into the table in device memory.

#include <algorithm>
#include <climits>
#include <cstdint>
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

constexpr int kUqThreads = 512;
constexpr int kUqIdsPerBlock = 8192;    // the smem add: one block an SM at most
constexpr int kGlobalBlocksPerSm = 2;   // the device-memory add
constexpr int kCacheBits = 11;
constexpr int kCache = 1 << kCacheBits;

// The slot of id at one depth, as cms_slot, with the floor of
// h mod (2^31 - 1) taken by selects: h is an int32, so h, h + P or
// h + 2P lies in [0, P).
__device__ __forceinline__ int uq_slot(int id, int a, int b, int width,
                                       bool pow2) {
  const int h = (int)((unsigned)id * (unsigned)a + (unsigned)b);
  int m;
  if (h >= 0) {
    m = h == kP ? 0 : h;
  } else {
    m = h + kP;                        // in [-1, P - 1)
    if (m < 0) m += kP;                // h = -2^31
  }
  return pow2 ? (m & (width - 1)) : m % width;
}

// f(id) for every id, 4 a thread a trip from 16-byte loads (the first
// 4 * n4 ids), then one.
template <typename F>
__device__ __forceinline__ void for_each_id(const int* __restrict__ ids,
                                            long long n, long long n4,
                                            F&& f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = tid; q < n4; q += stride) {
    const int4 v = reinterpret_cast<const int4*>(ids)[q];
    f(v.x);
    f(v.y);
    f(v.z);
    f(v.w);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) f(ids[i]);
}

// c more of id at every depth of cells (depth, width): the table in
// device memory, or a block's copy of its rows in shared memory.
__device__ __forceinline__ void add_all_depths(int* cells,
                                               const int* __restrict__ seeds,
                                               int depth, int width, bool pow2,
                                               int id, int c) {
  for (int d = 0; d < depth; ++d)
    atomicAdd(cells + (long long)d * width +
                  uq_slot(id, __ldg(seeds + 2 * d), __ldg(seeds + 2 * d + 1),
                          width, pow2),
              c);
}

__global__ void __launch_bounds__(kUqThreads)
uq_add_smem(const int* __restrict__ ids, long long n, long long n4,
            const int* __restrict__ seeds, int depth, int width, bool pow2,
            int* __restrict__ table) {
  extern __shared__ int rows[];
  const int cells = depth * width;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) rows[j] = 0;
  __syncthreads();
  for_each_id(ids, n, n4, [&](int id) {
    add_all_depths(rows, seeds, depth, width, pow2, id, 1);
  });
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const int v = rows[j];
    if (v) atomicAdd(table + j, v);
  }
}

// c more of id: into the block's entry for id where it holds one or can
// take a free one, else straight into the table.
__device__ __forceinline__ void add_cached(unsigned long long* key,
                                           int* count, int* table,
                                           const int* __restrict__ seeds,
                                           int depth, int width, bool pow2,
                                           int id, int c) {
  const unsigned long long want = (unsigned long long)(unsigned)id + 1ull;
  const int e = (int)(((unsigned)id * 2654435761u) >> (32 - kCacheBits));
  unsigned long long k = key[e];
  if (k == 0ull) {
    k = atomicCAS(key + e, 0ull, want);
    if (k == 0ull) k = want;
  }
  if (k == want)
    atomicAdd(count + e, c);
  else
    add_all_depths(table, seeds, depth, width, pow2, id, c);
}

__global__ void __launch_bounds__(kUqThreads)
uq_add_global(const int* __restrict__ ids, long long n, long long n4,
              const int* __restrict__ seeds, int depth, int width, bool pow2,
              int* __restrict__ table) {
  // entry e holds id + 1 (0: empty) and its count so far in this block
  __shared__ unsigned long long key[kCache];
  __shared__ int count[kCache];
  for (int e = threadIdx.x; e < kCache; e += blockDim.x) {
    key[e] = 0ull;
    count[e] = 0;
  }
  __syncthreads();
  for_each_id(ids, n, n4, [&](int id) {
    add_cached(key, count, table, seeds, depth, width, pow2, id, 1);
  });
  __syncthreads();
  for (int e = threadIdx.x; e < kCache; e += blockDim.x) {
    const unsigned long long k = key[e];
    if (k && count[e])
      add_all_depths(table, seeds, depth, width, pow2,
                     (int)(unsigned)(k - 1ull), count[e]);
  }
}

__device__ __forceinline__ int min_over_depths(const int* __restrict__ table,
                                               const int* __restrict__ seeds,
                                               int depth, int width, bool pow2,
                                               int id) {
  int m = INT_MAX;
  for (int d = 0; d < depth; ++d)
    m = min(m, table[(long long)d * width +
                     uq_slot(id, __ldg(seeds + 2 * d),
                             __ldg(seeds + 2 * d + 1), width, pow2)]);
  return m;
}

constexpr int kStageCells = 12288;       // 48 KiB: no opt-in needed
constexpr int kStageThreads = 1024;

// kStaged: each block first copies the table into shared memory (where
// depth * width <= kStageCells) and gathers from there.
template <bool kStaged>
__global__ void uq_query(const int* __restrict__ ids, long long n,
                         long long n4, const int* __restrict__ seeds,
                         int depth, int width, bool pow2,
                         const int* __restrict__ table,
                         int* __restrict__ est) {
  extern __shared__ int staged[];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the first ids are on their way while the table is staged
  const int4 first = tid < n4 ? reinterpret_cast<const int4*>(ids)[tid]
                              : make_int4(0, 0, 0, 0);
  const int* tab = table;
  if (kStaged) {
    for (int j = threadIdx.x; j < depth * width; j += blockDim.x)
      staged[j] = table[j];
    __syncthreads();
    tab = staged;
  }
  for (long long q = tid; q < n4; q += stride) {
    const int4 v = q == tid ? first : reinterpret_cast<const int4*>(ids)[q];
    int4 m;
    m.x = min_over_depths(tab, seeds, depth, width, pow2, v.x);
    m.y = min_over_depths(tab, seeds, depth, width, pow2, v.y);
    m.z = min_over_depths(tab, seeds, depth, width, pow2, v.z);
    m.w = min_over_depths(tab, seeds, depth, width, pow2, v.w);
    reinterpret_cast<int4*>(est)[q] = m;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    est[i] = min_over_depths(tab, seeds, depth, width, pow2, ids[i]);
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

// table = src (a copy; zeros where src is null) + the counts of ids (n,)
// int32 at every depth, on stream s: the fill, then one uq_add launch.
cudaError_t fill_and_add(const int* ids, long long n, const int* seeds,
                         int depth, int width, const int* src, int* table,
                         cudaStream_t s) {
  const long long cells = (long long)depth * width;
  cudaError_t e =
      src ? (src == table ? cudaSuccess
                          : cudaMemcpyAsync(table, src, cells * sizeof(int),
                                            cudaMemcpyDeviceToDevice, s))
          : cudaMemsetAsync(table, 0, cells * sizeof(int), s);
  if (e != cudaSuccess || n == 0) return e;
  const bool pow2 = (width & (width - 1)) == 0;
  const long long n4 = (uintptr_t)ids % 16 ? 0 : n / 4;
  const long long units = n4 + (n - 4 * n4);
  if (cells <= kMaxSmemWidth) {
    const size_t smem = (size_t)cells * sizeof(int);
    if (smem > (size_t)kDefaultSmem) {
      e = cudaFuncSetAttribute(uq_add_smem,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    const long long blocks = std::max(
        1LL, std::min(ceil_div(n, kUqIdsPerBlock), (long long)sm_count()));
    uq_add_smem<<<(unsigned)blocks, kUqThreads, smem, s>>>(
        ids, n, n4, seeds, depth, width, pow2, table);
  } else {
    const long long blocks = std::max(
        1LL, std::min(ceil_div(units, kUqThreads),
                      (long long)kGlobalBlocksPerSm * sm_count()));
    uq_add_global<<<(unsigned)blocks, kUqThreads, 0, s>>>(
        ids, n, n4, seeds, depth, width, pow2, table);
  }
  return cudaGetLastError();
}

}  // namespace

// table (depth, width) int32 = src + the counts of ids (n,) int32, or the
// counts alone where src is null; src is not modified (it may be table
// itself: an add in place). seeds (depth, 2) int32 holds each depth's
// (a, b).
extern "C" int countmin_add(const int* ids, long long n, const int* seeds,
                            int depth, int width, const int* src, int* table,
                            void* stream) {
  if (depth <= 0 || width <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  return (int)fill_and_add(ids, n, seeds, depth, width, src, table,
                           static_cast<cudaStream_t>(stream));
}

// The witness: adds the counts of ids into table in place, with the
// increment's first kernels (cms_add_smem / cms_add_global).
extern "C" int countmin_add_witness(const int* ids, long long n,
                                    const int* seeds, int depth, int width,
                                    int* table, void* stream) {
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

// new_table = table + the counts of ids (n,) int32 at every depth, and
// est[i] = min over depths of new_table[d, slot_d(ids[i])]; table is not
// modified. seeds (depth, 2) int32 holds each depth's (a, b).
extern "C" int countmin_update_query(const int* ids, long long n,
                                     const int* seeds, int depth, int width,
                                     const int* table, int* new_table,
                                     int* est, void* stream) {
  if (depth <= 0 || width <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      fill_and_add(ids, n, seeds, depth, width, table, new_table, s);
  if (e != cudaSuccess || n == 0) return (int)e;
  const long long cells = (long long)depth * width;
  const bool pow2 = (width & (width - 1)) == 0;
  const long long n4 =
      ((uintptr_t)ids | (uintptr_t)est) % 16 ? 0 : n / 4;
  const long long units = n4 + (n - 4 * n4);
  if (cells <= kStageCells) {
    const long long qblocks = std::max(
        1LL, std::min(ceil_div(units, kStageThreads), 2LL * sm_count()));
    uq_query<true><<<(unsigned)qblocks, kStageThreads, cells * sizeof(int),
                     s>>>(ids, n, n4, seeds, depth, width, pow2, new_table,
                          est);
  } else {
    const long long qblocks =
        std::max(1LL, std::min(ceil_div(units, kThreads), 16LL * sm_count()));
    uq_query<false><<<(unsigned)qblocks, kThreads, 0, s>>>(
        ids, n, n4, seeds, depth, width, pow2, new_table, est);
  }
  return (int)cudaGetLastError();
}
