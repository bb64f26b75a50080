// Misra-Gries heavy-hitter scan over a batch of ids (sm_90a).
//
// The JAX package steps its Misra-Gries summary with jax.lax.scan over the
// ids (streams/sketches.py::mg_update); it has no Pallas kernel. Per id:
// a hit on the first slot whose key equals the id (stale keys with count 0
// included) adds one; otherwise the first slot whose count is 0 takes the
// id with count 1; otherwise every count drops by one. Each step depends
// on the one before, so the scan is bound by the latency of that chain,
// not by bytes or operations. Integer state only: every entry point here is
// bitwise the plain loop's, for any k from 1 to 1,024.
//
// mg_scan takes the ids that cannot change the chain off it. Call a slot
// safe for a stretch of ids if, in a state read at or before the stretch,
// it is the first slot holding its key K and its count exceeds the number
// of ids from that state to the stretch's end. Through the stretch it
// cannot reach 0, so K stays in it, every K is a hit on it that changes no
// other slot, and no other id hits it or takes it. So the K's can be
// counted apart, and the slot ends at count + hits - D, where D is the
// number of decrements among the other ids. One block per call,
// warp-specialised, over chunks of kChunk ids:
//   - warps 1-8 classify chunk c + 1 against the state at the start of
//     chunk c (threshold len(c) + len(c + 1)): they list the safe slots,
//     count each one's hits (warp-aggregated shared-memory atomics) and
//     compact the other ids in order into a shared-memory buffer (ballots
//     per 32 ids, then a prefix over the warps' counts);
//   - warp 0 meanwhile walks chunk c's compacted ids. The safe slots take
//     part as any slot does: their keys are not among those ids and their
//     counts stay above 0, so each only takes the walk's D decrements.
//     Then they gain their hits, and warp 0 publishes the state at the
//     start of chunk c + 1.
// Buffers, hit counts and the published state are double-buffered by
// chunk parity; one __syncthreads a chunk. The chain warp owns slot
// s = lane * KPL + j in register j of `lane`, so the first slot with a
// property is the lowest lane with it and that lane's lowest j. Per id it
// issues the hit and the empty ballots together and selects from both, one
// dependent vote round where the serial kernel has two, with no slot masks
// where k fills the registers (k = 64 on the path).
//
// mg_scan_serial is the kernel this one replaced (one warp walks every id;
// slot j * 32 + lane; a hit round, then an empty round), kept as a fast
// exact witness off every main path.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kClassWarps = 8;                  // warps 1..8 classify
constexpr int kClassThreads = 32 * kClassWarps;
constexpr int kThreads = 32 + kClassThreads;    // warp 0 walks the chain
constexpr int kSerialTile = 4096;
// ids a chunk (kChunk), a multiple of 32 * kClassWarps. At k = 64 on a
// Zipf(1.3) batch, 512 and 1,024 ran within 3% of each other and 256 to
// 4,096 within 20%; 1,024 walks half as many chunks as 512.
constexpr int kChunk = 1024;

// ---------------------------------------------------------------------------
// the chunked kernel
// ---------------------------------------------------------------------------

// Shared memory of the chunked kernel for k <= 32 * KPL; the two chunk
// parities' copies are [0] and [1].
template <int KPL>
struct Smem {
  static constexpr int kMaxK = 32 * KPL;
  int snap_key[2][kMaxK], snap_cnt[2][kMaxK], hits[2][kMaxK];
  int buf[2][kChunk];
  int safe_key[kMaxK], safe_slot[kMaxK];
  unsigned keep_bits[kChunk / 32];
  int warp_cnt[kClassWarps];
  int len[2];
  int nsafe;
};

__device__ __forceinline__ void class_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(kClassThreads) : "memory");
}

// Warps 1..8: classify ids[start, start + len) against the state of
// parity sb with threshold thr: count each safe slot's hits into hits[b]
// and compact the other ids, in order, into buf[b][0, len[b]).
template <int KPL>
__device__ void classify(Smem<KPL>& sm, int b, int sb,
                         const int* __restrict__ ids, long long start,
                         int len, int thr, int k) {
  const int ct = threadIdx.x - 32;
  const int cw = ct >> 5, lane = ct & 31;
  const int* skey = sm.snap_key[sb];
  const int* scnt = sm.snap_cnt[sb];
  int* hits = sm.hits[b];
  int* buf = sm.buf[b];
  for (int s = ct; s < k; s += kClassThreads) hits[s] = 0;
  if (ct == 0) sm.nsafe = 0;
  class_sync();
  // the safe slots: count above thr, and no earlier slot with the key
  for (int s = ct; s < k; s += kClassThreads) {
    if (scnt[s] > thr) {
      const int key = skey[s];
      bool first = true;
      for (int j = 0; j < s; ++j) first &= skey[j] != key;
      if (first) {
        const int e = atomicAdd(&sm.nsafe, 1);
        sm.safe_key[e] = key;
        sm.safe_slot[e] = s;
      }
    }
  }
  class_sync();
  const int ns = sm.nsafe;
  constexpr int seg = kChunk / kClassWarps;
  const int lo = cw * seg, hi = min(lo + seg, len);
  // pass 1: hits per safe slot, and a ballot of the kept ids
  int kept = 0;
  for (int g = lo; g < hi; g += 32) {
    const int i = g + lane;
    const bool in = i < hi;
    const int x = in ? ids[start + i] : 0;
    int slot = -1;
    for (int e = 0; e < ns; ++e)
      slot = sm.safe_key[e] == x ? sm.safe_slot[e] : slot;
    slot = in ? slot : -1;
    const unsigned kb = __ballot_sync(kFull, in && slot < 0);
    const unsigned hb = __ballot_sync(kFull, slot >= 0);
    if (slot >= 0) {
      const unsigned peers = __match_any_sync(hb, slot);
      if (lane == __ffs(peers) - 1) atomicAdd(&hits[slot], __popc(peers));
    }
    if (lane == 0) sm.keep_bits[g >> 5] = kb;
    kept += __popc(kb);
  }
  if (lane == 0) sm.warp_cnt[cw] = kept;
  class_sync();
  // pass 2: the kept ids, in order, at this warp's offset
  int off = 0;
  for (int w = 0; w < cw; ++w) off += sm.warp_cnt[w];
  const unsigned below = (1u << lane) - 1u;
  for (int g = lo; g < hi; g += 32) {
    const unsigned kb = sm.keep_bits[g >> 5];
    if ((kb >> lane) & 1u) buf[off + __popc(kb & below)] = ids[start + g + lane];
    off += __popc(kb);
  }
  if (cw == kClassWarps - 1 && lane == 0) sm.len[b] = off;
}

// One step of the chain warp over id x. With FULL (k = 32 * KPL) every
// register holds a live slot; otherwise live has bit j set where register
// j does, and a dead slot (count pinned far from 0) never takes a hit.
// below: this lane's lanes-below mask. Written so that it compiles to
// selects, with no branch.
template <int KPL, bool FULL>
__device__ __forceinline__ void mg_step(int x, unsigned below, unsigned live,
                                        int (&key)[KPL], int (&cnt)[KPL]) {
  const unsigned lanebit = below + 1u;
  bool h = false, e = false;
  int jh = 0, je = 0;      // this lane's first hit and first empty register
#pragma unroll
  for (int j = KPL - 1; j >= 0; --j) {
    if (key[j] == x && (FULL || ((live >> j) & 1u))) {
      h = true;
      jh = j;
    }
    if (cnt[j] == 0) {
      e = true;
      je = j;
    }
  }
  const unsigned bh = __ballot_sync(kFull, h);
  const unsigned be = __ballot_sync(kFull, e);
  const unsigned src = bh ? bh : be;   // the first hit, else the first empty
  const int j = bh ? jh : je;
  const bool mine = (src & (lanebit | below)) == lanebit;
  const int down = src ? 0 : 1;
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) {
    const bool sel = mine & (jj == j);
    key[jj] = sel ? x : key[jj];
    cnt[jj] += (int)sel - down;
  }
}

template <int KPL, bool FULL>
__device__ __forceinline__ void walk(const int* q, int n, unsigned below,
                                     unsigned live, int (&key)[KPL],
                                     int (&cnt)[KPL]) {
  constexpr int U = KPL <= 2 ? 32 : (KPL <= 8 ? 8 : 2);
  const int lane = threadIdx.x & 31;
  int i = 0;
  for (; i + 32 <= n; i += 32) {
    const int v = q[i + lane];
    for (int t0 = 0; t0 < 32; t0 += U) {
#pragma unroll
      for (int t = 0; t < U; ++t)
        mg_step<KPL, FULL>(__shfl_sync(kFull, v, t0 + t), below, live, key,
                           cnt);
    }
  }
  if (i < n) {
    const int v = i + lane < n ? q[i + lane] : 0;
    for (int t = 0; t < n - i; ++t)
      mg_step<KPL, FULL>(__shfl_sync(kFull, v, t), below, live, key, cnt);
  }
}

constexpr int kDeadCount = 1 << 30;   // a dead slot's count: never 0

template <int KPL, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
mg_chunked_kernel(const int* __restrict__ ids, long long n, int k,
                  int* __restrict__ keys, int* __restrict__ counts,
                  long long* __restrict__ stats) {
  __shared__ Smem<KPL> sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long nch = (n + kChunk - 1) / kChunk;
  auto clen = [&](long long c) {
    return (int)min((long long)kChunk, n - c * kChunk);
  };

  int key[KPL], cnt[KPL];
  unsigned live = 0u;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int s = lane * KPL + j;
      const bool l = s < k;
      live |= (l ? 1u : 0u) << j;
      key[j] = l ? keys[s] : 0;
      cnt[j] = l ? counts[s] : kDeadCount;
      if (l) {
        sm.snap_key[0][s] = key[j];
        sm.snap_cnt[0][s] = cnt[j];
      }
    }
  }
  __syncthreads();
  if (warp > 0) classify(sm, 0, 0, ids, 0, clen(0), clen(0), k);
  __syncthreads();

  long long chained = 0;
  for (long long c = 0; c < nch; ++c) {
    const int b = (int)(c & 1), nb = b ^ 1;
    if (warp == 0) {
      // the safe slots take part as any slot: their keys are not among
      // these ids and their counts stay above 0, so each takes exactly
      // the walk's decrements; then they gain their hits
      const int m = sm.len[b];
      walk<KPL, FULL>(sm.buf[b], m, below, live, key, cnt);
      chained += m;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int s = lane * KPL + j;
        if ((live >> j) & 1u) {
          cnt[j] += sm.hits[b][s];
          sm.snap_key[nb][s] = key[j];
          sm.snap_cnt[nb][s] = cnt[j];
        }
      }
    } else if (c + 1 < nch) {
      const int len0 = clen(c), len1 = clen(c + 1);
      classify(sm, nb, b, ids, (c + 1) * kChunk, len1, len0 + len1, k);
    }
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if ((live >> j) & 1u) {
        keys[lane * KPL + j] = key[j];
        counts[lane * KPL + j] = cnt[j];
      }
    }
    if (lane == 0 && stats != nullptr) {
      stats[0] += chained;
      stats[1] += n;
    }
  }
}

// ---------------------------------------------------------------------------
// the serial witness
// ---------------------------------------------------------------------------

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
__global__ void mg_serial_kernel(const int* __restrict__ ids, long long n,
                                 int k, int* __restrict__ keys,
                                 int* __restrict__ counts) {
  __shared__ int tile[kSerialTile];
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
  for (long long base = 0; base < n; base += kSerialTile) {
    const int m = (int)min((long long)kSerialTile, n - base);
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

template <int KPL>
int launch_chunked(const int* ids, long long n, int k, int* keys, int* counts,
                   long long* stats, cudaStream_t s) {
  if (k == 32 * KPL)
    mg_chunked_kernel<KPL, true><<<1, kThreads, 0, s>>>(ids, n, k, keys,
                                                        counts, stats);
  else
    mg_chunked_kernel<KPL, false><<<1, kThreads, 0, s>>>(ids, n, k, keys,
                                                         counts, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps the summary (keys, counts: (k,) int32, read and overwritten) over
// ids (n,) int32 in order, taking the safe slots' ids off the chain; one
// block, chunks of kChunk ids; k from 1 to 1,024. stats (2 int64, or
// null) gains the ids the chain walked and the ids seen.
extern "C" int mg_scan(const int* ids, long long n, int k, int* keys,
                       int* counts, long long* stats, void* stream) {
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_lane = (k + 31) / 32;
  if (per_lane <= 1) return launch_chunked<1>(ids, n, k, keys, counts, stats, s);
  if (per_lane <= 2) return launch_chunked<2>(ids, n, k, keys, counts, stats, s);
  if (per_lane <= 4) return launch_chunked<4>(ids, n, k, keys, counts, stats, s);
  if (per_lane <= 8) return launch_chunked<8>(ids, n, k, keys, counts, stats, s);
  if (per_lane <= 16)
    return launch_chunked<16>(ids, n, k, keys, counts, stats, s);
  return launch_chunked<32>(ids, n, k, keys, counts, stats, s);
}

// The serial witness: the same result, every id on one warp's chain.
extern "C" int mg_scan_serial(const int* ids, long long n, int k, int* keys,
                              int* counts, void* stream) {
  if (k < 1 || k > 1024) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (k + 31) / 32;
  if (groups <= 1)
    mg_serial_kernel<1><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 2)
    mg_serial_kernel<2><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 4)
    mg_serial_kernel<4><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 8)
    mg_serial_kernel<8><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else if (groups <= 16)
    mg_serial_kernel<16><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  else
    mg_serial_kernel<32><<<1, 32, 0, s>>>(ids, n, k, keys, counts);
  return (int)cudaGetLastError();
}
