// Error-feedback int8 wire round-trips for the uplink codecs (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/ef_codec.py::
// ef_int8_roundtrip (_int8_kernel) and ::ef_topk_int8_roundtrip
// (_topk_int8_kernel). Both are memory-bound: per element they read x and
// the residual and write the decoded value and the new residual (16
// bytes) for a handful of flops.
//
// int8_ef (ef_roundtrip): two kernels on the caller's stream.
//   1. amax: a grid-stride max of |x + r| (of the kept coordinates when a
//      top-k threshold is given). The values are >= 0, so their IEEE bit
//      patterns order like the floats: each block reduces the bits with
//      __reduce_max_sync and issues one atomicMax. Max is exact, so the
//      result does not depend on the order blocks run in. A NaN (bits
//      above +inf) wins the max, as jnp.max propagates it.
//   2. apply: scale = max(amax, 1e-30) / 127, q = clip(rint(xc / scale)),
//      dec = q * scale, r' = xc - dec, elementwise.
// rintf rounds half to even like jnp.round. The products and differences
// use the _rn intrinsics and the file is built with -fmad=false, so no
// multiply-add is contracted and dec + r' == x + r holds exactly.
// The second pass reads x and r again: 24 bytes moved per element where
// the bound counts 16. ef_roundtrip with a threshold is the top-k path
// this file had before ef_topk_roundtrip: the wrapper keeps it, behind
// torch.topk's threshold, as the new path's witness.
//
// topk_int8_ef (ef_topk_roundtrip): the threshold t, the k-th largest
// |x + r|, is found on the card by an exact radix select over the bit
// patterns of |x + r| (31 bits: the sign is clear; NaN orders above
// +inf, as in torch.topk and lax.top_k), with no host sync:
//   0. select_sample reads 65,536 keys at even strides and picks the
//      window of top-digit bins (key bits 30..19, 4,096 bins) that holds
//      their k-th largest in proportion, give or take 4 sigma + 16 ranks.
//   1. select_pass1 reads x and r once: a shared-memory histogram of the
//      top digit merged into device memory with integer atomics, the max
//      key (amax), and the keys whose top digit lies in the window, kept
//      in device scratch (a warp's keys leave in batches, one atomic on
//      the count a batch). The last block to finish picks the digit bin
//      that holds the k-th largest and the rank left inside it.
//   2. select_pass2 counts the keys of the chosen bin: their bits 18..9 in
//      shared memory (1,024 bins) and their bits 18..0 in device memory
//      (2^19 bins, warp-aggregated atomics). It takes them from the kept
//      keys where those hold the whole bin; where the bin fell outside the
//      window or the keys outgrew their room (n / 8) it reads x and r
//      again, from the end backwards (the part pass 1 read last may still
//      sit in the L2). Its last block picks the coarse bin and then the
//      fine bin: all 31 bits, so t is exact whatever the sample saw.
//   3. topk_apply: the apply above, 16-byte loads, kept = |xc| >= t.
// Up to 65,536 elements there is no sample and pass 2 reads x and r again
// (measured faster there than keeping every key).
// The amax of the kept set is max |x + r| itself, since t never exceeds
// it; with a NaN anywhere the threshold is NaN and nothing is kept, which
// is what torch.topk(...).min() gave the path before. Counts are integers,
// so the select is exact and the same whatever order blocks run in.
// 24 bytes move per element (one select read, then the apply) where the
// bound counts 16, plus the sample's sectors and the kept keys. Measured
// at 16,777,216 elements (H100 80GB HBM3, 700 W, CUDA-graph replays):
// 0.182 ms, the select 0.085; reading x and r twice instead, 0.200 and
// 0.099, pass 2 gaining from reading backwards. More loads in flight a
// thread, other grids, streaming stores and keeping keys through per-lane
// buffers moved nothing; at 65,536 elements keeping every key was slower
// than reading x and r again.

#include <algorithm>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQmax = 127.0f;

__global__ void amax_kernel(const float* __restrict__ x,
                            const float* __restrict__ r, long long n,
                            const float* __restrict__ thresh,
                            unsigned* __restrict__ amax_bits) {
  const float t = thresh ? *thresh : 0.0f;
  unsigned m = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float a = fabsf(__fadd_rn(x[i], r[i]));
    if (thresh && !(a >= t)) a = 0.0f;
    m = max(m, __float_as_uint(a));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (threadIdx.x == 0) atomicMax(amax_bits, v);
  }
}

__global__ void apply_kernel(const float* __restrict__ x,
                             const float* __restrict__ r, long long n,
                             const float* __restrict__ thresh,
                             const unsigned* __restrict__ amax_bits,
                             float* __restrict__ dec,
                             float* __restrict__ rout) {
  const float amax = __uint_as_float(*amax_bits);
  // jnp.maximum propagates NaN where fmaxf would drop it
  const float floor_amax = (amax != amax) ? amax : fmaxf(amax, 1e-30f);
  const float scale = __fdiv_rn(floor_amax, kQmax);
  const float t = thresh ? *thresh : 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xc = __fadd_rn(x[i], r[i]);
    const bool kept = !thresh || fabsf(xc) >= t;
    float q = rintf(__fdiv_rn(kept ? xc : 0.0f, scale));
    // clip that keeps NaN, as jnp.clip does
    q = q < -kQmax ? -kQmax : (q > kQmax ? kQmax : q);
    const float d = kept ? __fmul_rn(q, scale) : 0.0f;
    dec[i] = d;
    rout[i] = __fsub_rn(xc, d);
  }
}

// ---- top-k: the radix select and its apply -------------------------------

constexpr int kSelThreads = 512;
constexpr int kSelBlocksPerSm = 4;
constexpr int kD1Shift = 19;                    // digit 1: key bits 30..19
constexpr int kD1Bins = 1 << (31 - kD1Shift);   // 4,096
constexpr int kCoarseShift = 9;                 // digit 2: key bits 18..9
constexpr int kCoarseBins = 1 << (kD1Shift - kCoarseShift);   // 1,024
constexpr int kFineBins = 1 << kD1Shift;        // key bits 18..0
constexpr int kFinePerCoarse = 1 << kCoarseShift;               // 512
constexpr int kSample = 65536;                  // keys the window comes from
constexpr int kSampleBlocks = kSample / (4 * kSelThreads);
constexpr int kWarpBuf = 256;                   // a warp's keys not yet out
constexpr int kWarpFlush = 128;
constexpr unsigned kFull = 0xffffffffu;

// scratch (uint32 words): a header, the histograms, then the keys pass 1
// keeps (kept_room(n) of them)
enum : int {
  kAmax = 0,      // max key over all elements
  kThresh = 1,    // the apply's threshold: t, or NaN where a key is NaN
  kSelect = 2,    // t, the k-th largest key
  kDigit1 = 3,    // pass 1's bin
  kRank1 = 4,     // the rank of t among the keys of that bin
  kDone0 = 5,     // blocks of the sample finished
  kDone1 = 6,     // blocks of pass 1 finished
  kDone2 = 7,     // blocks of pass 2 finished
  kWinLo = 8,     // pass 1 keeps the keys whose digit 1 lies in [lo, hi]
  kWinHi = 9,
  kCount = 10,    // keys pass 1 kept (past the room too)
  kKeptAll = 11,  // 1: the kept keys hold every key of pass 1's bin
  kHist0 = 16,    // the sample's digit 1
  kHist1 = kHist0 + kD1Bins,
  kCoarse = kHist1 + kD1Bins,
  kFine = kCoarse + kCoarseBins,
  kKept = kFine + kFineBins,
};

__host__ __device__ inline long long kept_room(long long n) {
  return n / 8 > kSample ? n / 8 : (long long)kSample;
}

__device__ __forceinline__ unsigned key_of(float x, float r) {
  return __float_as_uint(fabsf(__fadd_rn(x, r)));
}

// f(key, valid) for every element, 4 a trip from 16-byte loads (the first
// 4 * n4 elements) and then one a trip; every lane of a warp takes the
// same trips, so f may use warp-wide intrinsics.
template <typename F>
__device__ __forceinline__ void for_each_key(const float* __restrict__ x,
                                             const float* __restrict__ r,
                                             long long n, long long n4,
                                             bool backwards, F&& f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long warp0 = (long long)blockIdx.x * blockDim.x +
                          (threadIdx.x & ~31);
  const int lane = threadIdx.x & 31;
  const long long trips = (n4 + stride - 1) / stride;
  for (long long t = 0; t < trips; ++t) {
    const long long base = (backwards ? trips - 1 - t : t) * stride + warp0;
    if (base >= n4) continue;                 // the same for the whole warp
    const long long q = base + lane;
    const bool valid = q < n4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (valid) {
      a = reinterpret_cast<const float4*>(x)[q];
      b = reinterpret_cast<const float4*>(r)[q];
    }
    f(key_of(a.x, b.x), valid);
    f(key_of(a.y, b.y), valid);
    f(key_of(a.z, b.z), valid);
    f(key_of(a.w, b.w), valid);
  }
  for (long long base = 4 * n4 + warp0; base < n; base += stride) {
    const long long i = base + lane;
    const bool valid = i < n;
    f(valid ? key_of(x[i], r[i]) : 0u, valid);
  }
}

// The last block of a grid to get here returns true, after every block's
// atomics are visible. All threads of the block call it.
__device__ __forceinline__ bool last_block(unsigned* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The whole block: over hist[0, bins) (device memory, read past the L1),
// the highest bin whose count with the bins above reaches k, and k less
// the count above it, in *bin and *rank. bins is a multiple of blockDim.x.
__device__ void pick_bin(const unsigned* hist, int bins, unsigned k,
                         unsigned* bin, unsigned* rank) {
  __shared__ unsigned warp_sum[kSelThreads / 32];
  const int per = bins / blockDim.x;          // 1, 2 or 8
  const int lo = threadIdx.x * per;
  unsigned h[8], s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = j < per ? __ldcg(hist + lo + j) : 0u;
    s += h[j];
  }
  // the count of the threads above this one: within the warp by a
  // suffix scan, then the warps above
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) warp_sum[warp] = incl;
  __syncthreads();
  unsigned above = incl - s;
  for (int w = warp + 1; w < (int)(blockDim.x >> 5); ++w) above += warp_sum[w];
  if (above < k && k <= above + s) {
    for (int j = per - 1; j >= 0; --j) {
      if (above + h[j] >= k) {
        *bin = lo + j;
        *rank = k - above;
        break;
      }
      above += h[j];
    }
  }
  __syncthreads();
}

// kSample keys at even strides: the window of digit-1 bins that holds
// the k-th largest key with a margin of 4 sigma + 16 sample ranks, for
// pass 1 to keep.
__global__ void __launch_bounds__(kSelThreads)
select_sample(const float* __restrict__ x, const float* __restrict__ r,
              long long n, unsigned k, unsigned* __restrict__ scratch) {
  __shared__ unsigned hist[kD1Bins];
  __shared__ unsigned pick[4];
  for (int j = threadIdx.x; j < kD1Bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  unsigned keys[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long j = ((long long)blockIdx.x * 4 + u) * blockDim.x +
                        threadIdx.x;
    const long long i = j * n / kSample;
    keys[u] = key_of(x[i], r[i]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) atomicAdd(&hist[keys[u] >> kD1Shift], 1u);
  __syncthreads();
  for (int j = threadIdx.x; j < kD1Bins; j += blockDim.x) {
    const unsigned v = hist[j];
    if (v) atomicAdd(scratch + kHist0 + j, v);
  }
  if (!last_block(scratch + kDone0)) return;
  const double p = (double)k / (double)n, rank = p * kSample;
  const double margin = 4.0 * sqrt(rank * (1.0 - p)) + 16.0;
  pick_bin(scratch + kHist0, kD1Bins,
           (unsigned)fmax(1.0, floor(rank - margin)), &pick[0], &pick[1]);
  pick_bin(scratch + kHist0, kD1Bins,
           (unsigned)fmin((double)kSample, ceil(rank + margin)), &pick[2],
           &pick[3]);
  if (threadIdx.x == 0) {
    scratch[kWinHi] = pick[0];
    scratch[kWinLo] = pick[2];
  }
}

// The warp's pending keys out to kept[], past one atomic on the count;
// keys beyond the room are dropped (the count still says how many).
__device__ __forceinline__ void flush_kept(const unsigned* buf,
                                           unsigned pending,
                                           unsigned* __restrict__ scratch,
                                           long long room) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  unsigned base = 0u;
  if (lane == 0 && pending) base = atomicAdd(scratch + kCount, pending);
  base = __shfl_sync(kFull, base, 0);
  for (unsigned j = lane; j < pending; j += 32)
    if ((long long)base + j < room) scratch[kKept + base + j] = buf[j];
  __syncwarp();
}

// kKeep: keep the keys in the sample's window; without (n <= kSample: no
// sample was taken) nothing is kept and pass 2 reads x and r again.
template <bool kKeep>
__global__ void __launch_bounds__(kSelThreads)
select_pass1(const float* __restrict__ x, const float* __restrict__ r,
             long long n, long long n4, unsigned k,
             unsigned* __restrict__ scratch) {
  __shared__ unsigned hist[kD1Bins];
  __shared__ unsigned warp_max[kSelThreads / 32];
  __shared__ unsigned warp_buf[kKeep ? kSelThreads / 32 : 1]
                              [kKeep ? kWarpBuf : 1];
  __shared__ unsigned pick[2];
  for (int j = threadIdx.x; j < kD1Bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  const unsigned lo = kKeep ? scratch[kWinLo] : 1u;
  const unsigned hi = kKeep ? scratch[kWinHi] : 0u;
  const long long room = kept_room(n);
  const int lane = threadIdx.x & 31;
  unsigned* buf = warp_buf[kKeep ? threadIdx.x >> 5 : 0];
  unsigned pending = 0u, m = 0u;
  for_each_key(x, r, n, n4, false, [&](unsigned key, bool valid) {
    const unsigned digit = key >> kD1Shift;
    if (valid) {
      m = max(m, key);
      atomicAdd(&hist[digit], 1u);
    }
    if (!kKeep) return;
    const bool keep = valid && digit >= lo && digit <= hi;
    const unsigned want = __ballot_sync(kFull, keep);
    if (!want) return;
    if (keep) buf[pending + __popc(want & ((1u << lane) - 1u))] = key;
    pending += __popc(want);
    if (pending >= kWarpFlush) {
      flush_kept(buf, pending, scratch, room);
      pending = 0u;
    }
  });
  if (kKeep) flush_kept(buf, pending, scratch, room);
  m = __reduce_max_sync(kFull, m);
  if (lane == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = threadIdx.x < kSelThreads / 32 ? warp_max[threadIdx.x] : 0u;
    v = __reduce_max_sync(kFull, v);
    if (threadIdx.x == 0) atomicMax(scratch + kAmax, v);
  }
  for (int j = threadIdx.x; j < kD1Bins; j += blockDim.x) {
    const unsigned v = hist[j];
    if (v) atomicAdd(scratch + kHist1 + j, v);
  }
  if (!last_block(scratch + kDone1)) return;
  pick_bin(scratch + kHist1, kD1Bins, k, &pick[0], &pick[1]);
  if (threadIdx.x == 0) {
    scratch[kDigit1] = pick[0];
    scratch[kRank1] = pick[1];
    scratch[kKeptAll] = pick[0] >= lo && pick[0] <= hi &&
                        (long long)__ldcg(scratch + kCount) <= room;
  }
}

// f(key, valid) over the keys pass 1 kept, the trips the same for a warp.
template <typename F>
__device__ __forceinline__ void for_each_kept(const unsigned* __restrict__ kept,
                                              long long count, F&& f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * blockDim.x +
                        (threadIdx.x & ~31);
       base < count; base += stride) {
    const long long i = base + lane;
    const bool valid = i < count;
    f(valid ? kept[i] : 0u, valid);
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_pass2(const float* __restrict__ x, const float* __restrict__ r,
             long long n, long long n4, unsigned* __restrict__ scratch) {
  __shared__ unsigned coarse[kCoarseBins];
  __shared__ unsigned pick[4];
  for (int j = threadIdx.x; j < kCoarseBins; j += blockDim.x) coarse[j] = 0u;
  __syncthreads();
  const unsigned digit1 = scratch[kDigit1];
  unsigned* fine = scratch + kFine;
  auto tally = [&](unsigned key, bool valid) {
    const bool in = valid && (key >> kD1Shift) == digit1;
    if (!__any_sync(kFull, in)) return;
    // lanes with the same key bits add their number once, through the
    // lowest of them: ties at the threshold do not queue on one address
    const unsigned low = key & (kFineBins - 1);
    const unsigned peers = __match_any_sync(kFull, in ? low : kFull);
    if (in && (threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(&coarse[low >> kCoarseShift], __popc(peers));
      atomicAdd(fine + low, __popc(peers));
    }
  };
  if (scratch[kKeptAll])
    for_each_kept(scratch + kKept, scratch[kCount], tally);
  else
    for_each_key(x, r, n, n4, true, tally);
  __syncthreads();
  for (int j = threadIdx.x; j < kCoarseBins; j += blockDim.x) {
    const unsigned v = coarse[j];
    if (v) atomicAdd(scratch + kCoarse + j, v);
  }
  if (!last_block(scratch + kDone2)) return;
  pick_bin(scratch + kCoarse, kCoarseBins, scratch[kRank1], &pick[0],
           &pick[1]);
  pick_bin(fine + pick[0] * kFinePerCoarse, kFinePerCoarse, pick[1],
           &pick[2], &pick[3]);
  if (threadIdx.x == 0) {
    const unsigned t = (digit1 << kD1Shift) | (pick[0] << kCoarseShift) |
                       pick[2];
    scratch[kSelect] = t;
    scratch[kThresh] = scratch[kAmax] > 0x7f800000u ? 0x7fc00000u : t;
  }
}

// apply_kernel's arithmetic, element for element, with the threshold and
// amax from the select's scratch.
__device__ __forceinline__ void topk_one(float x, float r, float t,
                                         float scale, float* dec,
                                         float* rout) {
  const float xc = __fadd_rn(x, r);
  const bool kept = fabsf(xc) >= t;
  float q = rintf(__fdiv_rn(kept ? xc : 0.0f, scale));
  q = q < -kQmax ? -kQmax : (q > kQmax ? kQmax : q);
  const float d = kept ? __fmul_rn(q, scale) : 0.0f;
  *dec = d;
  *rout = __fsub_rn(xc, d);
}

__global__ void topk_apply(const float* __restrict__ x,
                           const float* __restrict__ r, long long n,
                           long long n4,
                           const unsigned* __restrict__ scratch,
                           float* __restrict__ dec,
                           float* __restrict__ rout) {
  const float amax = __uint_as_float(scratch[kAmax]);
  const float floor_amax = (amax != amax) ? amax : fmaxf(amax, 1e-30f);
  const float scale = __fdiv_rn(floor_amax, kQmax);
  const float t = __uint_as_float(scratch[kThresh]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = tid; q < n4; q += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[q];
    const float4 b = reinterpret_cast<const float4*>(r)[q];
    float4 d, o;
    topk_one(a.x, b.x, t, scale, &d.x, &o.x);
    topk_one(a.y, b.y, t, scale, &d.y, &o.y);
    topk_one(a.z, b.z, t, scale, &d.z, &o.z);
    topk_one(a.w, b.w, t, scale, &d.w, &o.w);
    reinterpret_cast<float4*>(dec)[q] = d;
    reinterpret_cast<float4*>(rout)[q] = o;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    topk_one(x[i], r[i], t, scale, dec + i, rout + i);
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

// The select into scratch (scratch_words(n) words): t in scratch[kSelect].
int topk_select(const float* x, const float* r, long long n, long long n4,
                long long k, unsigned* scratch, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(scratch, 0, kKept * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const bool all = n <= kSample;
  if (!all) {
    select_sample<<<kSampleBlocks, kSelThreads, 0, s>>>(x, r, n, (unsigned)k,
                                                       scratch);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = n4 + (n - 4 * n4);
  long long blocks = (units + kSelThreads - 1) / kSelThreads;
  blocks = std::max(1LL, std::min(blocks, (long long)kSelBlocksPerSm *
                                              sm_count()));
  if (all)
    select_pass1<false><<<(unsigned)blocks, kSelThreads, 0, s>>>(
        x, r, n, n4, (unsigned)k, scratch);
  else
    select_pass1<true><<<(unsigned)blocks, kSelThreads, 0, s>>>(
        x, r, n, n4, (unsigned)k, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_pass2<<<(unsigned)blocks, kSelThreads, 0, s>>>(x, r, n, n4, scratch);
  return (int)cudaGetLastError();
}

bool topk_args_ok(long long n, long long k) {
  return n >= 1 && n < (1LL << 32) && k >= 1 && k <= n;
}

long long quads(const void* a, const void* b, const void* c, const void* d,
                long long n) {
  const uintptr_t any = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                        (uintptr_t)d;
  return any % 16 ? 0 : n / 4;
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;   // 16 resident blocks on each of 132 SMs
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// (decoded, residual') of x + r, int8 against the amax of the kept
// coordinates. thresh == nullptr keeps every coordinate (int8_ef); else
// coordinates with |x + r| >= *thresh are kept and the rest decode to 0
// (topk_int8_ef). scratch: one uint32 of device memory.
extern "C" int ef_roundtrip(const float* x, const float* r,
                            const float* thresh, float* dec, float* rout,
                            unsigned* scratch, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const int grid = grid_for(n);
  amax_kernel<<<grid, kThreads, 0, s>>>(x, r, n, thresh, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_kernel<<<grid, kThreads, 0, s>>>(x, r, n, thresh, scratch, dec, rout);
  return (int)cudaGetLastError();
}

// The words of device scratch that ef_topk_select and ef_topk_roundtrip
// take for n elements.
extern "C" long long ef_topk_scratch_words(long long n) {
  return kKept + kept_room(n);
}

// t = the k-th largest |x + r| over n elements (1 <= k <= n < 2^32), by
// the radix select, into scratch[2] (as float bits).
extern "C" int ef_topk_select(const float* x, const float* r, long long n,
                              long long k, unsigned* scratch, void* stream) {
  if (!topk_args_ok(n, k)) return (int)cudaErrorInvalidValue;
  return topk_select(x, r, n, quads(x, r, x, r, n), k, scratch,
                     static_cast<cudaStream_t>(stream));
}

// (decoded, residual') of x + r for topk_int8_ef: coordinates with
// |x + r| >= t are kept and int8-quantized against max |x + r|, the rest
// decode to 0. scratch: ef_topk_scratch_words(n) words of device memory.
extern "C" int ef_topk_roundtrip(const float* x, const float* r, long long n,
                                 long long k, float* dec, float* rout,
                                 unsigned* scratch, void* stream) {
  if (!topk_args_ok(n, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = quads(x, r, dec, rout, n);
  const int rc = topk_select(x, r, n, n4, k, scratch, s);
  if (rc != 0) return rc;
  topk_apply<<<grid_for(n4 + (n - 4 * n4)), kThreads, 0, s>>>(
      x, r, n, n4, scratch, dec, rout);
  return (int)cudaGetLastError();
}
