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
// (_normalize_kernel). It is bound by bytes: x read once, y written once
// (8 bytes an element; at the path's 65,536 x 256, 64 MiB of x, more than
// the 50 MB L2). The TPU kernel visits its row blocks twice, carrying
// the batch sums across its sequential grid in VMEM. Here one call is one
// persistent kernel, normalize_persistent, launched cooperatively with
// exactly the CTAs that fit at once (one an SM), so that a grid-wide
// barrier is safe; a CUDA graph captures the launch as one kernel node.
// Each CTA owns a contiguous slice of rows and works in three phases:
//   1. load and sum: it reads its slice once (16-byte loads where d % 4
//      == 0 and x is aligned), replaces NaN with the prior mean, keeps
//      its first rows in shared memory (up to ~220 KB a CTA, ~29 MB over
//      132 SMs) and reads the rest with an L2 evict-last policy (the
//      staged rows with evict-first), so that they are still in the L2
//      for phase 3. Each thread sums x and x^2 of its column over its row
//      lane in row order; the lanes are added in lane order in shared
//      memory, and the CTA writes one (sum x, sum x^2) partial a column;
//   2. a grid barrier; then each CTA takes a contiguous share of the
//      columns, stages their partials in shared memory (all loads in
//      flight at once), adds each column's partials in CTA order (no
//      float atomics: deterministic) and merges them with the running
//      state (Welford, from raw moments, as the TPU kernel does); a
//      second barrier;
//   3. normalize and write: the L2 rows first (evict-first: their last
//      use), then the staged rows, y with 16-byte streaming stores.
//   Measured (H100 80GB HBM3, 700 W, 65,536 x 256; globaltimer stamps a
//   CTA in a development build): phase 1 ~24 us (2.7 TB/s of reads),
//   the first barrier ~2 us, phase 3 ~23 us (2.9 TB/s of writes). Keeping
//   the first rows in registers as well (12 a thread) spilled and made
//   phase 3 slower; plain loads in place of the L2 policies made phase 3
//   ~5 us slower (its rows missed the L2); one thread a column adding 132
//   partials from the L2, 8 loads in flight, took ~7.5 us for the merge.
// The first kernels, kept as the witness (fused_normalize_witness):
//   1. moments_partial: each block sums x and x^2 (after NaN -> prior
//      mean) over a chunk of rows for 32 columns, 8 row lanes per column,
//      and writes one partial per (row chunk, column);
//   2. moments_finalize: one thread per column adds the partials in chunk
//      order and does the Welford merge from raw moments;
//   3. normalize_apply: y = (x - mean1) * rstd, elementwise.
// They read x twice (passes 1 and 3): 12 bytes moved per element where
// the bound counts 8.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// Welford merge of one column's batch raw moments (s1 = sum x, s2 =
// sum x^2 over nb rows) into its running (n0, mean0, m20).
struct Merged {
  float mean1, m21, rstd;
};

__device__ __forceinline__ Merged welford_merge(float s1, float s2, float nb,
                                                float n0, float mean0,
                                                float m20) {
  const float mean_b = s1 / nb;
  // batch m2 from raw moments: sum(x^2) - nb * mean_b^2
  const float m2_b = fmaxf(s2 - nb * mean_b * mean_b, 0.0f);
  const float n1 = n0 + nb;
  const float delta = mean_b - mean0;
  const float denom = fmaxf(n1, 1.0f);
  Merged m;
  m.mean1 = mean0 + delta * (nb / denom);
  m.m21 = m20 + m2_b + delta * delta * n0 * nb / denom;
  const float var = m.m21 / fmaxf(n1 - 1.0f, 1.0f);
  m.rstd = 1.0f / sqrtf(var + 1e-6f);
  return m;
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
  const Merged m = welford_merge(s1, s2, (float)n, n0, mean0[c], m20[c]);
  mean1[c] = m.mean1;
  m21[c] = m.m21;
  rstd[c] = m.rstd;
  if (c == 0) *n1_out = n0 + (float)n;
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

// -- the persistent normalize ------------------------------------------------

constexpr int kNormThreads = 512;
constexpr int kNormUnroll = 8;    // rows a thread loads before it uses them
constexpr int kMergeCols = 4;     // columns a CTA merges at a time

template <int V>
struct alignas(4 * V) Vals {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vals<V> load_hinted(const float* p, uint64_t pol) {
  Vals<V> r;
  if constexpr (V == 4) {
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
                 : "l"(p), "l"(pol));
  } else {
    asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(r.v[0])
                 : "l"(p), "l"(pol));
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_streaming(float* p, const Vals<V>& a) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  else
    __stcs(p, a.v[0]);
}

// V floats a load (4 where d % 4 == 0 and x, y are 16-byte aligned);
// stage_rows rows a CTA keeps in shared memory, after red_floats of
// scratch for the lane sums and the merge. part: (2, gridDim.x, d)
// partials; stats: (2, d), mean1 then rstd.
template <int V>
__global__ void __launch_bounds__(kNormThreads, 1)
normalize_persistent(const float* __restrict__ x,
                     const float* __restrict__ n0p,
                     const float* __restrict__ mean0,
                     const float* __restrict__ m20, float* __restrict__ y,
                     float* __restrict__ n1_out, float* __restrict__ mean1_out,
                     float* __restrict__ m21_out, float* part, float* stats,
                     int n, int d, int impute, int red_floats,
                     int stage_rows) {
  extern __shared__ float4 norm_smem[];
  Vals<V>* red = reinterpret_cast<Vals<V>*>(norm_smem);   // kNormThreads
  float* stage = reinterpret_cast<float*>(norm_smem) + red_floats;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const long long r0 = (long long)b * n / G;
  const int rows = (int)((long long)(b + 1) * n / G - r0);
  const int Q = d / V;                        // column vectors a row
  const int Qt = min(Q, kNormThreads);        // a column tile
  const int L = kNormThreads / Qt;            // row lanes
  const int lane = t / Qt, qc = t % Qt;
  // local rows [0, staged): shared memory; then the L2
  const int staged = min(rows, stage_rows);
  const float* xs = x + r0 * d;
  float* ys = y + r0 * d;
  uint64_t keep, drop;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(drop));

  // 1. load and sum: each thread its column over its lane's rows, in order
  for (int ct = 0; ct < Q; ct += Qt) {
    const int q = ct + qc, col = q * V;
    const bool on = lane < L && q < Q;
    float m0[V], s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m0[k] = on ? mean0[col + k] : 0.0f;
      s1[k] = 0.0f;
      s2[k] = 0.0f;
    }
    auto take = [&](Vals<V>& a) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (impute && isnan(a.v[k])) a.v[k] = m0[k];
        s1[k] += a.v[k];
        s2[k] += a.v[k] * a.v[k];
      }
    };
    if (on) {
      for (int r = lane; r < rows; r += kNormUnroll * L) {
        Vals<V> a[kNormUnroll];
#pragma unroll
        for (int u = 0; u < kNormUnroll; ++u) {
          const int rr = r + u * L;
          if (rr < rows)
            a[u] = load_hinted<V>(xs + (long long)rr * d + col,
                                  rr < staged ? drop : keep);
        }
#pragma unroll
        for (int u = 0; u < kNormUnroll; ++u) {
          const int rr = r + u * L;
          if (rr < rows) {
            take(a[u]);
            if (rr < staged)
              *reinterpret_cast<Vals<V>*>(stage + rr * d + col) = a[u];
          }
        }
      }
    }
    // the lanes' sums of each column, added in lane order: one partial a
    // CTA and column
    auto reduce = [&](const float(&s)[V], int which) {
      __syncthreads();                          // red is free
      if (lane < L) {
        Vals<V> a;
#pragma unroll
        for (int k = 0; k < V; ++k) a.v[k] = s[k];
        red[t] = a;
      }
      __syncthreads();
      if (lane == 0 && on) {
        float acc[V] = {};
        for (int l = 0; l < L; ++l) {
          const Vals<V> a = red[l * Qt + qc];
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] += a.v[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k)
          part[((long long)which * G + b) * d + col + k] = acc[k];
      }
    };
    reduce(s1, 0);
    reduce(s2, 1);
  }

  // 2. every CTA's partials in; each CTA takes a contiguous share of the
  // columns, kMergeCols at a time: their partials staged in shared memory
  // by all threads at once, then one thread a column adds them in CTA
  // order and merges
  grid.sync();
  float* mbuf = reinterpret_cast<float*>(norm_smem);   // 2 * G * kMergeCols
  const float n0 = *n0p, nb = (float)n;
  const int share = (d + G - 1) / G;
  const int c_end = min(d, (b + 1) * share);
  for (int c0 = b * share; c0 < c_end; c0 += kMergeCols) {
    const int nc = min(kMergeCols, c_end - c0);
    __syncthreads();
    for (int i = t; i < 2 * G * nc; i += kNormThreads) {
      const int k = i / nc;                 // which * G + CTA
      mbuf[i] = __ldcg(part + (long long)k * d + c0 + (i - k * nc));
    }
    __syncthreads();
    if (t < nc) {
      const int c = c0 + t;
      float a1 = 0.0f, a2 = 0.0f;
      for (int k = 0; k < G; ++k) {
        a1 += mbuf[k * nc + t];
        a2 += mbuf[(G + k) * nc + t];
      }
      const Merged m = welford_merge(a1, a2, nb, n0, mean0[c], m20[c]);
      stats[c] = m.mean1;
      stats[d + c] = m.rstd;
      mean1_out[c] = m.mean1;
      m21_out[c] = m.m21;
      if (c == 0) *n1_out = n0 + nb;
    }
  }
  grid.sync();

  // 3. normalize and write: the L2's rows first (their last use), then the
  // staged ones
  for (int ct = 0; ct < Q; ct += Qt) {
    const int q = ct + qc, col = q * V;
    if (lane >= L || q >= Q) continue;
    float m0[V], mu[V], rs[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m0[k] = mean0[col + k];
      mu[k] = __ldcg(stats + col + k);
      rs[k] = __ldcg(stats + d + col + k);
    }
    auto put = [&](int rr, Vals<V> a, bool fill) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float u = a.v[k];
        if (fill && impute && isnan(u)) u = m0[k];
        a.v[k] = (u - mu[k]) * rs[k];
      }
      store_streaming<V>(ys + (long long)rr * d + col, a);
    };
    // the first of the lane's rows at or past the staged ones
    const int first = staged + ((lane - staged % L) + L) % L;
    for (int r = first; r < rows; r += kNormUnroll * L) {
      Vals<V> a[kNormUnroll];
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u)
        if (r + u * L < rows)
          a[u] = load_hinted<V>(xs + (long long)(r + u * L) * d + col, drop);
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u)
        if (r + u * L < rows) put(r + u * L, a[u], true);
    }
    for (int r = lane; r < staged; r += L)
      put(r, *reinterpret_cast<const Vals<V>*>(stage + r * d + col), false);
  }
}

int max_block_smem() {
  static int smem = 0;
  if (!smem) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem <= 0) smem = 48 * 1024;
  }
  return smem;
}

template <int V>
int launch_normalize(const float* x, const float* n0, const float* mean0,
                     const float* m20, float* y, float* n1, float* mean1,
                     float* m21, float* part, float* stats, int n, int d,
                     int impute, int grid, cudaStream_t s) {
  const auto kern = normalize_persistent<V>;
  const int red_floats = std::max(kNormThreads * V, 2 * grid * kMergeCols);
  // rows a CTA owns at most, and the rows its shared memory can hold
  const long long per_cta = ((long long)n + grid - 1) / grid;
  const long long room = ((long long)max_block_smem() - red_floats * 4LL) /
                         ((long long)d * 4);
  const int stage_rows = (int)std::max(0LL, std::min(room, per_cta));
  const size_t smem = ((size_t)red_floats + (size_t)stage_rows * d) *
                      sizeof(float);
  static size_t opted = kDefaultDynamicSmem;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kNormThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kNormThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, x, n0, mean0, m20, y, n1, mean1, m21,
                         part, stats, n, d, impute, red_floats, stage_rows);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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

// CTAs of the persistent normalize, one an SM; the caller sizes its
// scratch with it: 2 * grid * d + 2 * d floats.
extern "C" int normalize_grid() { return sm_count(); }

// y (n, d), n1 (1), mean1 (d), m21 (d) from x (n, d) and the running state
// n0 (1), mean0 (d), m20 (d): one launch of normalize_persistent.
extern "C" int fused_normalize(const float* x, const float* n0,
                               const float* mean0, const float* m20, float* y,
                               float* n1, float* mean1, float* m21,
                               float* scratch, int n, int d, int impute,
                               void* stream) {
  if (n < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = sm_count();
  float* part = scratch;
  float* stats = scratch + 2LL * grid * d;
  if (d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0)
    return launch_normalize<4>(x, n0, mean0, m20, y, n1, mean1, m21, part,
                               stats, n, d, impute, grid, s);
  return launch_normalize<1>(x, n0, mean0, m20, y, n1, mean1, m21, part,
                             stats, n, d, impute, grid, s);
}

// The witness: the first kernels (moments_partial, moments_finalize,
// normalize_apply). normalize_chunks(n) row chunks; scratch: 2 * chunks *
// d + d floats.
extern "C" int normalize_chunks(int n) { return (n + kChunk - 1) / kChunk; }

extern "C" int fused_normalize_witness(const float* x, const float* n0,
                                       const float* mean0, const float* m20,
                                       float* y, float* n1, float* mean1,
                                       float* m21, float* scratch, int n,
                                       int d, int impute, void* stream) {
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
