// Misra-Gries heavy-hitter scan over a batch of ids (sm_90a).
//
// The JAX package steps its Misra-Gries summary with jax.lax.scan over the
// ids (streams/sketches.py::mg_update); it has no Pallas kernel. Each step
// depends on the one before, so the scan is latency-bound, as the drift
// detector scan is: one warp owns the k slots and walks the ids in order.
// Slot s = j * 32 + lane lives in register j of lane `lane`, so slots are
// visited in index order group by group. Per id:
//   1. a hit: __ballot_sync over each group of 32 slots for key == id,
//      stale keys with count 0 included; the first group with a bit set
//      and __ffs of its bits give the first hit, which is what jnp's argmax
//      picks. The slot adds one.
//   2. else the first slot whose count is 0, found the same way, takes the
//      id with count 1 (its count was 0, so it too adds one).
//   3. else every count drops by one.
// The ids are staged through shared memory in tiles with coalesced loads.
// Integer state only, so the result is bitwise the plain loop's for any k
// up to 1,024 (32 slots a lane). Slots past k are dead: never hit, never
// empty, never decremented.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;
constexpr unsigned kFull = 0xffffffffu;

// The first group j whose ballot of pred[j] has a bit set: returns j and
// sets `bits` to that ballot, or returns -1. The same on every lane.
template <int KPL>
__device__ __forceinline__ int first_group(const bool (&pred)[KPL],
                                           unsigned& bits) {
  int g = -1;
  bits = 0u;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const unsigned bj = __ballot_sync(kFull, pred[j]);
    if (g < 0 && bj) {
      g = j;
      bits = bj;
    }
  }
  return g;
}

template <int KPL>
__global__ void mg_scan_kernel(const int* __restrict__ ids, long long n,
                               int k, int* __restrict__ keys,
                               int* __restrict__ counts) {
  __shared__ int tile[kTile];
  const int lane = threadIdx.x;
  int key[KPL], cnt[KPL];
  bool live[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int s = j * 32 + lane;
    live[j] = s < k;
    key[j] = live[j] ? keys[s] : 0;
    cnt[j] = live[j] ? counts[s] : 1;
  }
  for (long long base = 0; base < n; base += kTile) {
    const int m = (int)min((long long)kTile, n - base);
    __syncwarp();
    for (int i = lane; i < m; i += 32) tile[i] = ids[base + i];
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int item = tile[i];
      bool pred[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) pred[j] = live[j] && key[j] == item;
      unsigned bits;
      int g = first_group(pred, bits);
      if (g < 0) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) pred[j] = live[j] && cnt[j] == 0;
        g = first_group(pred, bits);
      }
      if (g >= 0) {
        const bool mine = lane == __ffs(bits) - 1;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          if (mine && j == g) {
            key[j] = item;
            cnt[j] += 1;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < KPL; ++j) cnt[j] -= live[j] ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    if (live[j]) {
      keys[j * 32 + lane] = key[j];
      counts[j * 32 + lane] = cnt[j];
    }
  }
}

}  // namespace

// Steps the summary (keys, counts: (k,) int32, read and overwritten) over
// ids (n,) int32 in order. One warp; k from 1 to 1,024.
extern "C" int mg_scan(const int* ids, long long n, int k, int* keys,
                       int* counts, void* stream) {
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (k + 31) / 32;
  if (groups <= 1)
    mg_scan_kernel<1><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 2)
    mg_scan_kernel<2><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 4)
    mg_scan_kernel<4><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 8)
    mg_scan_kernel<8><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 16)
    mg_scan_kernel<16><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else
    mg_scan_kernel<32><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  return (int)cudaGetLastError();
}
