// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the JAX package's kernels/flash_attention.py::flash_attention_bhsd
// (_flash_fwd_kernel, grid (B*H, q_blocks, kv_blocks)) and its model-layout
// wrapper flash_attention. On the TPU the kv axis is the innermost,
// sequential grid axis and the online-softmax accumulators live in VMEM
// scratch across it; blocks here run in no order, so a block walks the KV
// tiles itself and keeps m, l and the fp32 accumulator in registers.
//
// Layout: the model's, read in place. q is (B, S, H, D) and k, v are
// (B, T, KV, D), each with its own element strides for the batch, position
// and head axes; only the last axis must be contiguous, and every row must
// start 16 bytes aligned. Query head h reads KV head h / (H / KV): GQA is
// an index, not a copy. o is (B, S, H, D), contiguous, in q's type.
// Semantics are the TPU kernel's: kpos < T always; with causal, kpos <= qpos
// (both counted from 0, start-aligned) and KV tiles wholly above the
// diagonal are skipped; masked scores are -1e30 and l is floored at 1e-30.
// (The bf16 kernels mask with -inf and subtract 0 in a row with no key kept
// yet; every row keeps key 0, so a masked key weighs exactly 0 either way.)
// Head dims 16, 64, 128 and 256, fp32 or bf16.
//
// What bounds it. At the serving path's prefill shape (S = T = 512, D = 64,
// bf16) one (b, h) does 4*S*T*D operations on 2*(S+T)*D*2 bytes, 256 per
// byte: near the ~295 at which the H100's bf16 tensor cores, and not its
// memory, are the limit. At a decode step (S = 1) it is the bytes of K and V
// by far. Three kernels:
//
// - flash_fwd_mma (bf16): FlashAttention-2's forward on the tensor cores.
//   A block owns 64*MT query rows of one (b, h), four warps of 16*MT rows
//   (MT = 2 at D 64 and 128: each K and V fragment feeds two m-tiles; at
//   D 256 one m-tile, its 128 accumulators a thread, with Q read from its
//   tile at each k-step, fits the registers). K and
//   V come in tiles of 64 keys, two stages deep, by cp.async (16 bytes a
//   thread), so the next tile loads under this tile's products; shared
//   memory is XOR-swizzled in 16-byte chunks so that ldmatrix reads eight
//   rows without bank conflicts. S = Q K^T and O += P V are
//   mma.sync.m16n8k16 bf16 -> fp32; the online softmax runs on the
//   accumulator fragments in registers (exp2 of log2-scaled scores, one
//   MUFU instruction each), and P is packed from the S fragments straight
//   into the A operand of P V, with no trip through shared memory. P is
//   rounded to bf16 for that product, as FlashAttention-2 does; the TPU
//   kernel keeps P in fp32 (repro/kernels/flash_attention.py:66-68), so an
//   output moves by at most 2^-9 (bf16's relative rounding) times the
//   p-weighted mean of |v|, far inside the one-ulp check. The mask is a
//   select on a per-row key limit: a branch a score put 32 convergence
//   barriers in each tile and cost more than the products.
// - flash_decode_mma (bf16, (H/KV)*S <= 16 rows): the decode step, bound
//   by bytes. A block owns one (b, kv head) and all of its H/KV query heads
//   times S rows, padded to one 16-row tile, so K and V are read once per
//   group. Its four warps split each 64-key tile (16 keys a warp), three
//   or four stages deep, and merge their (m, l, acc) in shared memory at
//   the end (at D 256 Q is read from its tile at each k-step, and the
//   stages are three: 200 KB). Where B*KV blocks cannot fill the card, T
//   is split across
//   kv_splits blocks; each writes its partial (m, l, acc) to scratch, and
//   the last to finish (an atomic count, reset by that block) puts each
//   split's weight in shared memory and sums the partials 16 bytes at a
//   time, so a call is still one launch.
// - flash_fwd_f32 (fp32): the CUDA cores, register-blocked. Each lane holds
//   the scores of its two keys for all of its warp's rows, so one
//   shared-memory load of K (transposed) or V feeds several multiply-adds;
//   for the output a row spans min(D, 32) lanes, so D = 16 puts two rows on
//   a warp's 32 lanes.
//
// wgmma and TMA (a 64-row warpgroup product reading K and V straight from
// shared memory, with a producer warp keeping the loads in flight) are the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;           // keys per KV tile
constexpr int THREADS = 128;     // four warps a block, in every kernel
constexpr int DECODE_ROWS = 16;  // query rows of the decode kernel's tile

struct Strides {
  long long b, s, h;  // element strides of the batch, position, head axes
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, KV;
  Strides qs, ks, vs;
  int causal;
  int kv_splits;   // decode kernel: blocks T is split over
  float* part;     // with kv_splits > 1: B*KV*kv_splits*16*(D + 2) floats
  int* counters;   // with kv_splits > 1: B*KV zeros, left at zero
  float scale;
};

// KV tiles a block whose largest query position is qpos_max walks
__device__ __forceinline__ int kv_tiles(const Args& a, int qpos_max) {
  int n = (a.T + BK - 1) / BK;
  if (a.causal) n = min(n, qpos_max / BK + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of 16-byte chunk c of tile row `row` (rows of D bf16 values),
// XOR-swizzled so that the eight rows one ldmatrix phase reads at the same
// c lie in eight different 16-byte bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int c) {
  constexpr int CPR = D / 8;  // chunks a row
  int chunk;
  if constexpr (CPR >= 8)
    chunk = row * CPR + (c & ~7) + ((c ^ row) & 7);
  else
    chunk = row * CPR + (c ^ ((row / (8 / CPR)) % CPR));
  return static_cast<uint32_t>(chunk) * 16u;
}

// ROWS rows of a strided tensor (row r at base + r * stride), from row0 on,
// into a swizzled shared tile at sdst by cp.async; rows at or past
// rows_valid are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t sdst, const bf16* base,
                                          long long stride, int row0,
                                          int rows_valid, int tid) {
  constexpr int CPR = D / 8;
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
    const int ch = tid + j * THREADS;
    if (N % THREADS == 0 || ch < N) {
      const int r = ch / CPR, c = ch % CPR;
      const bool in = row0 + r < rows_valid;
      const bf16* src = in ? base + (long long)(row0 + r) * stride + c * 8
                           : base;
      cp_async16(sdst + swz<D>(r, c), src, in);
    }
  }
}

// 2^x in one MUFU instruction; denormal results flush to 0, as 2^-1e30 does
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's MT 16-row m-tiles of query rows against the 8*NT keys kofs..
// of the tile at (ks, vs), whose first key is at position k0: the
// online-softmax update of (m, l, acc). Each K and V fragment read from
// shared memory feeds all MT m-tiles. The Q A-fragments are in registers
// (QREG) or read from the Q tile (rows qrow0.. at qsm) at each k-step. Of
// m-tile mt this thread holds rows lane/4 (position qpos[mt][0]) and
// lane/4 + 8 (qpos[mt][1]); m is in the log2 domain, l is this thread's
// part of the row sum (the quad's four parts are added at the end).
template <int D, int NT, int MT, bool QREG>
__device__ __forceinline__ void attend(
    const uint32_t (&qf)[MT][QREG ? D / 16 : 1][4], uint32_t qsm, int qrow0,
    uint32_t ks, uint32_t vs, int kofs, int k0, const Args& a, bool mask,
    const int (&qpos)[MT][2], float scale_log2, float (&m)[MT][2],
    float (&l)[MT][2], float (&acc)[MT][D / 8][4], int lane) {
  float s[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
  // S = Q K^T: one ldmatrix.x4 gives two 8-key n-tiles of a 16-dim k-step
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[MT][4];
    if constexpr (!QREG) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qa[mt][0], qa[mt][1], qa[mt][2], qa[mt][3],
                qsm + swz<D>(qrow0 + 16 * mt + (lane & 15),
                             2 * kk + (lane >> 4)));
    }
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              ks + swz<D>(kofs + n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                          2 * kk + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
          mma_bf16(s[mt][2 * n2], qf[mt][kk], b0, b1);
          mma_bf16(s[mt][2 * n2 + 1], qf[mt][kk], b2, b3);
        } else {
          mma_bf16(s[mt][2 * n2], qa[mt], b0, b1);
          mma_bf16(s[mt][2 * n2 + 1], qa[mt], b2, b3);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mask) {
      // a key is kept below its row's limit: T, and with causal qpos + 1.
      // A select, not a branch a score: per-score branches put a
      // convergence barrier around each score and cost more than the
      // products
      const int lim0 = a.causal ? min(a.T, qpos[mt][0] + 1) : a.T;
      const int lim1 = a.causal ? min(a.T, qpos[mt][1] + 1) : a.T;
      const int kb = k0 + kofs + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][n][e] = kb + n * 8 + (e & 1) < (e < 2 ? lim0 : lim1)
                            ? s[mt][n][e]
                            : -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
    }
    // the four threads of a quad share a row
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // m in the log2 domain; a row with no key kept yet subtracts 0, so
    // that its masked scores give 2^-inf = 0 and its alpha 2^-inf = 0
    const float mn0 = fmaxf(m[mt][0], mx0 * scale_log2);
    const float mn1 = fmaxf(m[mt][1], mx1 * scale_log2);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = ex2(m[mt][0] - ms0), al1 = ex2(m[mt][1] - ms1);
    m[mt][0] = mn0;
    m[mt][1] = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[mt][n][0] = ex2(fmaf(s[mt][n][0], scale_log2, -ms0));
      s[mt][n][1] = ex2(fmaf(s[mt][n][1], scale_log2, -ms0));
      s[mt][n][2] = ex2(fmaf(s[mt][n][2], scale_log2, -ms1));
      s[mt][n][3] = ex2(fmaf(s[mt][n][3], scale_log2, -ms1));
      ps0 += s[mt][n][0] + s[mt][n][1];
      ps1 += s[mt][n][2] + s[mt][n][3];
    }
    l[mt][0] = l[mt][0] * al0 + ps0;
    l[mt][1] = l[mt][1] * al1 + ps1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[mt][dn][0] *= al0;
      acc[mt][dn][1] *= al0;
      acc[mt][dn][2] *= al1;
      acc[mt][dn][3] *= al1;
    }
  }
  // O += P V: the S fragments of n-tiles 2j, 2j+1 are the A operand of
  // k-step j; one ldmatrix.x4.trans of V gives two 8-dim n-tiles
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
      pa[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
      pa[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
      pa[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
    }
#pragma unroll
    for (int dn2 = 0; dn2 < D / 16; ++dn2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                vs + swz<D>(kofs + 16 * j + (lane & 7) +
                                (((lane >> 3) & 1) << 3),
                            2 * dn2 + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * dn2], pa[mt], b0, b1);
        mma_bf16(acc[mt][2 * dn2 + 1], pa[mt], b2, b3);
      }
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The Q A-fragments of m-tiles 0..MT-1 of a warp whose first row in the
// Q tile at qsm is qrow0
template <int D, int MT>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[MT][D / 16][4],
                                             uint32_t qsm, int qrow0,
                                             int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qf[mt][kk][0], qf[mt][kk][1], qf[mt][kk][2], qf[mt][kk][3],
              qsm + swz<D>(qrow0 + 16 * mt + (lane & 15),
                           2 * kk + (lane >> 4)));
}

// m-tiles a warp of the row kernel owns, and whether their Q fragments
// stay in registers. At D 64 and 128 two m-tiles halve the K and V
// fragments read from shared memory per product, which ran faster on the
// H100 at the serving shapes, and Q is read from its tile at each k-step
// to leave registers for the accumulators; at D = 16 one m-tile with Q in
// registers ran faster; at D = 256 one m-tile's 128 accumulators a
// thread leave no room for a second or for Q.
template <int D>
struct RowTiles {
  static constexpr int MT = (D >= 64 && D <= 128) ? 2 : 1;
  static constexpr bool QREG = D < 64;
};

// grid (ceil(S / BQ), H, B); BQ = 64*MT query rows of one (b, h) a block,
// 16*MT a warp
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma(Args a) {
  constexpr int MT = RowTiles<D>::MT, BQ = 64 * MT, STAGES = 2;
  constexpr bool QREG = RowTiles<D>::QREG;
  constexpr uint32_t TILE = BK * D * 2;  // bytes of a K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qsm = smem_u32(smem);
  const uint32_t kvsm = qsm + BQ * D * 2;  // stage st: K, then V
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the last query blocks walk the most tiles under causal: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (a.H / a.KV);
  const bf16* qg = (const bf16*)a.q + b * a.qs.b + h * a.qs.h;
  const bf16* kg = (const bf16*)a.k + b * a.ks.b + kvh * a.ks.h;
  const bf16* vg = (const bf16*)a.v + b * a.vs.b + kvh * a.vs.h;
  const int n_tiles = kv_tiles(a, min(q0 + BQ, a.S) - 1);

  load_rows<D, BQ>(qsm, qg, a.qs.s, q0, a.S, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_rows<D, BK>(kvsm + 2 * st * TILE, kg, a.ks.s, st * BK, a.T, tid);
      load_rows<D, BK>(kvsm + (2 * st + 1) * TILE, vg, a.vs.s, st * BK, a.T,
                       tid);
    }
    cp_async_commit();
  }

  uint32_t qf[MT][QREG ? D / 16 : 1][4];
  float m[MT][2], l[MT][2], acc[MT][D / 8][4];
  int qpos[MT][2];
  const int qrow0 = warp * 16 * MT;  // the warp's first row in the block
  const int row_lo = q0 + qrow0;     // and its query position
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
    qpos[mt][0] = row_lo + 16 * mt + (lane >> 2);
    qpos[mt][1] = qpos[mt][0] + 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      acc[mt][dn][0] = acc[mt][dn][1] = acc[mt][dn][2] = acc[mt][dn][3] = 0.f;
  }
  const float sl2 = a.scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t (and Q) have landed
    // tile t is visible to all, and all are done with tile t - 1, whose
    // stage tile t + STAGES - 1 goes to
    __syncthreads();
    const int tn = t + STAGES - 1;
    if (tn < n_tiles) {
      const int st = tn % STAGES;
      load_rows<D, BK>(kvsm + 2 * st * TILE, kg, a.ks.s, tn * BK, a.T, tid);
      load_rows<D, BK>(kvsm + (2 * st + 1) * TILE, vg, a.vs.s, tn * BK, a.T,
                       tid);
    }
    cp_async_commit();
    if constexpr (QREG) {
      if (t == 0) load_q_frags<D, MT>(qf, qsm, qrow0, lane);
    }
    const int k0 = t * BK;
    if (a.causal && k0 > row_lo + 16 * MT - 1) continue;  // above its rows
    const bool mask = k0 + BK > a.T || (a.causal && k0 + BK - 1 > row_lo);
    const int st = t % STAGES;
    attend<D, 8, MT, QREG>(qf, qsm, qrow0, kvsm + 2 * st * TILE,
                           kvsm + (2 * st + 1) * TILE, 0, k0, a, mask, qpos,
                           sl2, m, l, acc, lane);
  }

  bf16* og = (bf16*)a.o;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = qpos[mt][half];
      const float inv = 1.f / fmaxf(quad_sum(l[mt][half]), 1e-30f);
      if (qp >= a.S) continue;
      bf16* row = og + ((size_t)(b * a.S + qp) * a.H + h) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<uint32_t*>(row + dn * 8 + 2 * (lane & 3)) =
            pack_bf16(acc[mt][dn][2 * half] * inv,
                      acc[mt][dn][2 * half + 1] * inv);
    }
  }
}

// grid (B * KV, kv_splits); the (H / KV) * S <= 16 query rows of one
// (b, kv head), row r = g * S + s for query head kv * G + g at position s
template <int D, int STAGES>
__global__ void __launch_bounds__(THREADS) flash_decode_mma(Args a) {
  constexpr uint32_t TILE = BK * D * 2;
  constexpr int R16 = DECODE_ROWS;
  // Q's fragments in registers, but at D 256 (beside 128 accumulators)
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red_m[4][R16], red_l[4][R16];
  __shared__ int is_last;
  const uint32_t qsm = smem_u32(smem);
  const uint32_t kvsm = qsm + R16 * D * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV, R = G * a.S;
  const int bk = blockIdx.x, b = bk / a.KV, kvh = bk % a.KV;
  const int sp = blockIdx.y;
  const int n_all = kv_tiles(a, a.S - 1);
  const int per = (n_all + a.kv_splits - 1) / a.kv_splits;
  const int t0 = sp * per, nt = max(0, min(n_all, t0 + per) - t0);
  const bf16* qg = (const bf16*)a.q + b * a.qs.b;
  const bf16* kg = (const bf16*)a.k + b * a.ks.b + kvh * a.ks.h;
  const bf16* vg = (const bf16*)a.v + b * a.vs.b + kvh * a.vs.h;

  {
    constexpr int CPR = D / 8, N = R16 * CPR;
#pragma unroll
    for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
      const int ch = tid + j * THREADS;
      if (N % THREADS == 0 || ch < N) {
        const int r = ch / CPR, c = ch % CPR;
        const bool in = r < R;
        const bf16* src =
            in ? qg + (r % a.S) * a.qs.s + (kvh * G + r / a.S) * a.qs.h + c * 8
               : qg;
        cp_async16(qsm + swz<D>(r, c), src, in);
      }
    }
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) {
      load_rows<D, BK>(kvsm + 2 * st * TILE, kg, a.ks.s, (t0 + st) * BK, a.T,
                       tid);
      load_rows<D, BK>(kvsm + (2 * st + 1) * TILE, vg, a.vs.s,
                       (t0 + st) * BK, a.T, tid);
    }
    cp_async_commit();
  }

  uint32_t qf[1][QREG ? D / 16 : 1][4];
  float m[1][2] = {{-INFINITY, -INFINITY}}, l[1][2] = {{0.f, 0.f}};
  float acc[1][D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[0][dn][0] = acc[0][dn][1] = acc[0][dn][2] = acc[0][dn][3] = 0.f;
  const int qpos[1][2] = {{(lane >> 2) % a.S, ((lane >> 2) + 8) % a.S}};
  const float sl2 = a.scale * LOG2E;

  for (int t = 0; t < nt; ++t) {
    __syncthreads();
    const int tn = t + STAGES - 1;
    if (tn < nt) {
      const int st = tn % STAGES;
      load_rows<D, BK>(kvsm + 2 * st * TILE, kg, a.ks.s, (t0 + tn) * BK, a.T,
                       tid);
      load_rows<D, BK>(kvsm + (2 * st + 1) * TILE, vg, a.vs.s,
                       (t0 + tn) * BK, a.T, tid);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if constexpr (QREG) {
      if (t == 0) load_q_frags<D, 1>(qf, qsm, 0, lane);
    }
    const int k0 = (t0 + t) * BK;
    const int st = t % STAGES;
    attend<D, 2, 1, QREG>(qf, qsm, 0, kvsm + 2 * st * TILE,
                          kvsm + (2 * st + 1) * TILE, 16 * warp, k0, a,
                          a.causal || k0 + BK > a.T, qpos, sl2, m, l, acc,
                          lane);
  }

  // merge the four warps' (m, l, acc) through the freed stages
  cp_async_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem);  // [4][16][D]
  {
    const int g = lane >> 2;
    const float l0 = quad_sum(l[0][0]), l1 = quad_sum(l[0][1]);
    if ((lane & 3) == 0) {
      red_m[warp][g] = m[0][0];
      red_m[warp][g + 8] = m[0][1];
      red_l[warp][g] = l0;
      red_l[warp][g + 8] = l1;
    }
    float* w0 = red_acc + (warp * R16 + g) * D + 2 * (lane & 3);
    float* w1 = w0 + 8 * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      w0[dn * 8] = acc[0][dn][0];
      w0[dn * 8 + 1] = acc[0][dn][1];
      w1[dn * 8] = acc[0][dn][2];
      w1[dn * 8 + 1] = acc[0][dn][3];
    }
  }
  __syncthreads();
  bf16* og = (bf16*)a.o;
  // scratch of the split blocks: acc (B*KV, kv_splits, 16, D), then
  // (m, l) (B*KV, kv_splits, 16, 2)
  float* pacc = a.part + (size_t)bk * a.kv_splits * R16 * D;
  float* pml = a.part + (size_t)gridDim.x * a.kv_splits * R16 * D +
               (size_t)bk * a.kv_splits * R16 * 2;
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red_m[w][r]);
    const float mxs = mx == -INFINITY ? 0.f : mx;  // no key kept: weights 0
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = ex2(red_m[w][r] - mxs);
      lsum += wt * red_l[w][r];
      asum += wt * red_acc[(w * R16 + r) * D + d];
    }
    if (a.kv_splits == 1) {
      og[((size_t)(b * a.S + r % a.S) * a.H + kvh * G + r / a.S) * D + d] =
          __float2bfloat16_rn(asum / fmaxf(lsum, 1e-30f));
    } else {
      pacc[((size_t)sp * R16 + r) * D + d] = asum;
      if (d == 0) {
        pml[(sp * R16 + r) * 2] = mx;
        pml[(sp * R16 + r) * 2 + 1] = lsum;
      }
    }
  }
  if (a.kv_splits == 1) return;

  // the last split block of this (b, kv head) merges the splits: every
  // split's (m, l) into shared memory, the weight of split s in row r,
  // 2^(m_s - m) / sum_s' 2^(m_s' - m) l_s', beside them, then 4 outputs a
  // thread
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(a.counters + bk, 1) == a.kv_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* wts = red_acc;                     // [kv_splits][16]: m, weight
  float* lsp = wts + a.kv_splits * R16;     // [kv_splits][16]: l
  for (int i = tid; i < a.kv_splits * R; i += THREADS) {
    const int s = i / R, r = i % R;
    wts[s * R16 + r] = __ldcg(pml + (s * R16 + r) * 2);
    lsp[s * R16 + r] = __ldcg(pml + (s * R16 + r) * 2 + 1);
  }
  __syncthreads();
  for (int r = tid; r < R; r += THREADS) {
    // split 0 holds key 0, which every row keeps: mx is finite
    float mx = -INFINITY;
    for (int s = 0; s < a.kv_splits; ++s) mx = fmaxf(mx, wts[s * R16 + r]);
    float lsum = 0.f;
    for (int s = 0; s < a.kv_splits; ++s) {
      const float e = ex2(wts[s * R16 + r] - mx);
      wts[s * R16 + r] = e;
      lsum += e * lsp[s * R16 + r];
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    for (int s = 0; s < a.kv_splits; ++s) wts[s * R16 + r] *= inv;
  }
  __syncthreads();
  for (int idx = tid; idx < R * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), d = 4 * (idx % (D / 4));
    const float4* src =
        reinterpret_cast<const float4*>(pacc + (size_t)r * D + d);
    float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < a.kv_splits; ++s) {
      const float w = wts[s * R16 + r];
      const float4 x = __ldcg(src + (size_t)s * R16 * D / 4);
      o4.x += w * x.x;
      o4.y += w * x.y;
      o4.z += w * x.z;
      o4.w += w * x.w;
    }
    bf16* dst =
        og + ((size_t)(b * a.S + r % a.S) * a.H + kvh * G + r / a.S) * D + d;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o4.x, o4.y);
    *reinterpret_cast<uint32_t*>(dst + 2) = pack_bf16(o4.z, o4.w);
  }
  if (tid == 0) a.counters[bk] = 0;  // ready for the next call
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// N floats (a multiple of 4) to 16-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void store_f4(float* dst, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

__device__ __forceinline__ void unpack4(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// x[RG * i + rg] for a lane's row group rg, without a local-memory index
template <int RG, int N>
__device__ __forceinline__ float pick(const float (&x)[N], int i, int rg) {
  float v = x[RG * i];
#pragma unroll
  for (int j = 1; j < RG; ++j)
    if (rg == j) v = x[RG * i + j];
  return v;
}

// grid (ceil(S / 32), H, B); 32 query rows of one (b, h) a block
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Args a) {
  constexpr int BQ = 32, WARPS = THREADS / 32, RPW = BQ / WARPS;
  constexpr int DL = D < 32 ? D : 32;  // lanes one output row spans
  constexpr int RG = 32 / DL;          // rows a warp's lanes cover at once
  constexpr int DPL = D / DL;          // output dims a lane
  constexpr int RPL = RPW / RG;        // output rows a lane
  constexpr int KT = BK + 1;           // padded row stride of the K^T tile
  constexpr int CPR = D / 4;           // 16-byte chunks a row
  constexpr int QLD = BQ * CPR / THREADS;
  constexpr int KLD = BK * CPR / THREADS;
  constexpr int LB = KLD < 4 ? KLD : 4;  // chunks of K and V in flight
  static_assert(QLD >= 1 && KLD % LB == 0, "tile split");
  extern __shared__ float smf[];
  float* qs = smf;             // [BQ][D]
  float* kt = qs + BQ * D;     // [D][BK+1], K transposed
  float* vs = kt + D * KT;     // [BK][D]
  float* ps = vs + BK * D;     // [WARPS][RPW][BK], this tile's P

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * RPW;
  const int dl = lane % DL, rg = lane / DL;
  // a warp whose rows all lie past S loads tiles with the others but
  // computes nothing
  const bool active = q0 + row0 < a.S;
  const float* qg = (const float*)a.q + b * a.qs.b + h * a.qs.h;
  const float* kg = (const float*)a.k + b * a.ks.b + kvh * a.ks.h;
  const float* vg = (const float*)a.v + b * a.vs.b + kvh * a.vs.h;
  float* pw = ps + warp * RPW * BK;

#pragma unroll
  for (int j = 0; j < QLD; ++j) {
    const int ch = tid + j * THREADS;
    const int r = ch / CPR, c0 = (ch - r * CPR) * 4;
    const uint4 u = (q0 + r < a.S)
                        ? *reinterpret_cast<const uint4*>(
                              qg + (long long)(q0 + r) * a.qs.s + c0)
                        : make_uint4(0u, 0u, 0u, 0u);
    float f[4];
    unpack4(u, f);
    store_f4<4>(qs + r * D + c0, f);
  }

  float m[RPW], l[RPW], acc[RPL][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;

  const int n_tiles = kv_tiles(a, min(q0 + BQ, a.S) - 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int j0 = 0; j0 < KLD; j0 += LB) {
      uint4 ku[LB], vu[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int ch = tid + (j0 + j) * THREADS;
        const int r = ch / CPR, c0 = (ch - r * CPR) * 4;
        const bool in = k0 + r < a.T;
        ku[j] = in ? *reinterpret_cast<const uint4*>(
                         kg + (long long)(k0 + r) * a.ks.s + c0)
                   : make_uint4(0u, 0u, 0u, 0u);
        vu[j] = in ? *reinterpret_cast<const uint4*>(
                         vg + (long long)(k0 + r) * a.vs.s + c0)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int ch = tid + (j0 + j) * THREADS;
        const int r = ch / CPR, c0 = (ch - r * CPR) * 4;
        float f[4];
        unpack4(ku[j], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) kt[(c0 + e) * KT + r] = f[e];
        unpack4(vu[j], f);
        store_f4<4>(vs + r * D + c0, f);
      }
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for the warp's RPW rows and this lane's keys lane, lane+32
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float ka[4], kc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ka[e] = kt[(d + e) * KT + lane];
        kc[e] = kt[(d + e) * KT + lane + 32];
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (row0 + rr) * D + d);
        s[rr][0] += qv.x * ka[0] + qv.y * ka[1] + qv.z * ka[2] + qv.w * ka[3];
        s[rr][1] += qv.x * kc[0] + qv.y * kc[1] + qv.z * kc[2] + qv.w * kc[3];
      }
    }

    // online softmax, one row at a time across the warp
    float alpha[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qpos = q0 + row0 + rr;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool valid = kpos < a.T;
        if (a.causal) valid = valid && (kpos <= qpos);
        s[rr][j] = valid ? s[rr][j] * a.scale : NEG_INF;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(s[rr][0], s[rr][1])));
      const float p0 = expf(s[rr][0] - m_new);
      const float p1 = expf(s[rr][1] - m_new);
      alpha[rr] = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha[rr] + warp_sum(p0 + p1);
      m[rr] = m_new;
      pw[rr * BK + lane] = p0;
      pw[rr * BK + lane + 32] = p1;
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const float al = pick<RG>(alpha, i, rg);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= al;
    }
    __syncwarp();

    // acc += P V: lane owns rows rg + RG*i, dims dl + DL*dd
#pragma unroll 2
    for (int key = 0; key < BK; key += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          vv[e][dd] = vs[(key + e) * D + dl + DL * dd];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            pw + (rg + RG * i) * BK + key);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[i][dd] += p.x * vv[0][dd] + p.y * vv[1][dd] + p.z * vv[2][dd] +
                        p.w * vv[3][dd];
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

  float* og = (float*)a.o;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int qpos = q0 + row0 + rg + RG * i;
    if (qpos < a.S) {
      const float lv = fmaxf(pick<RG>(l, i, rg), 1e-30f);
      float* row = og + ((size_t)(b * a.S + qpos) * a.H + h) * D;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) row[dl + DL * dd] = acc[i][dd] / lv;
    }
  }
}

// ---------------------------------------------------------------------------
// head dims above 256, either type, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int WBQ = 16;   // query rows a block of the wide kernel
constexpr int WDC = 32;   // head-dim chunk its products walk
constexpr int WBK = 32;   // keys per KV tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Bytes of flash_fwd_wide's shared memory at head dim D; acc_in_smem:
// the output accumulator (WBQ x D floats) lives there too
__host__ __device__ inline size_t wide_smem(int D, bool acc_in_smem) {
  return sizeof(float) * (WBQ * WDC + WBK * (WDC + 1) + WBQ * WBK + 3 * WBQ +
                          (acc_in_smem ? (size_t)WBQ * D : 0));
}

// grid (ceil(S / 16), H, B); 16 query rows of one (b, h) a block, any D.
// S = Q K^T walks D in chunks of 32 (Q's and K's chunks staged in shared
// memory, four scores a thread); the online softmax takes a row a warp
// pass; O += P V walks D in chunks of 32 again, V's chunk staged, each
// thread four (row, dim) accumulators. The accumulator (16 x D fp32) is in
// shared memory, or, where it does not fit (acc != null), in acc, the
// block's 16 x D floats of scratch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wide(Args a, int D, float* __restrict__ acc_g) {
  extern __shared__ float smw[];
  float* qc = smw;                       // [WBQ][WDC]
  float* kc = qc + WBQ * WDC;            // [WBK][WDC + 1]: K's, then V's chunk
  float* sc = kc + WBK * (WDC + 1);      // [WBQ][WBK]: scores, then P
  float* rm = sc + WBQ * WBK;            // [WBQ]: m
  float* rl = rm + WBQ;                  // [WBQ]: l
  float* ra = rl + WBQ;                  // [WBQ]: this tile's alpha
  const int q0 = blockIdx.x * WBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  float* acc = acc_g == nullptr
                   ? ra + WBQ
                   : acc_g + (((size_t)b * gridDim.y + h) * gridDim.x +
                              blockIdx.x) * WBQ * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qg = (const T*)a.q + b * a.qs.b + h * a.qs.h;
  const T* kg = (const T*)a.k + b * a.ks.b + kvh * a.ks.h;
  const T* vg = (const T*)a.v + b * a.vs.b + kvh * a.vs.h;
  for (int i = tid; i < WBQ * D; i += THREADS) acc[i] = 0.f;
  if (tid < WBQ) {
    rm[tid] = NEG_INF;
    rl[tid] = 0.f;
  }
  // this thread's scores: row sr, keys sk + 8 j
  const int sr = tid / 8, sk = tid % 8;
  int n_tiles = (a.T + WBK - 1) / WBK;
  if (a.causal) n_tiles = min(n_tiles, (min(q0 + WBQ, a.S) - 1) / WBK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * WBK;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d0 = 0; d0 < D; d0 += WDC) {
      __syncthreads();   // the chunks before are no longer read
      for (int i = tid; i < WBQ * WDC; i += THREADS) {
        const int r = i / WDC, d = d0 + i % WDC, qpos = q0 + r;
        qc[i] = (qpos < a.S && d < D)
                    ? to_f(qg[(long long)qpos * a.qs.s + d]) : 0.f;
      }
      for (int i = tid; i < WBK * WDC; i += THREADS) {
        const int r = i / WDC, c = i % WDC, d = d0 + c, kpos = k0 + r;
        kc[r * (WDC + 1) + c] = (kpos < a.T && d < D)
            ? to_f(kg[(long long)kpos * a.ks.s + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < WDC; ++c) {
        const float qv = qc[sr * WDC + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += qv * kc[(sk + 8 * j) * (WDC + 1) + c];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + sk + 8 * j, qpos = q0 + sr;
      const bool valid = kpos < a.T && (!a.causal || kpos <= qpos);
      sc[sr * WBK + sk + 8 * j] = valid ? s[j] * a.scale : NEG_INF;
    }
    __syncthreads();
    // online softmax: warp w takes rows 4w .. 4w + 3, a key a lane
    for (int rr = 0; rr < WBQ / (THREADS / 32); ++rr) {
      const int row = warp * (WBQ / (THREADS / 32)) + rr;
      const float x = sc[row * WBK + lane];
      const float m_old = rm[row];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);
      const float sum = warp_sum(p);
      sc[row * WBK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        rl[row] = rl[row] * al + sum;
        rm[row] = m_new;
        ra[row] = al;
      }
    }
    // O = O alpha + P V, V's chunks staged where K's were
    for (int d0 = 0; d0 < D; d0 += WDC) {
      __syncthreads();
      for (int i = tid; i < WBK * WDC; i += THREADS) {
        const int r = i / WDC, c = i % WDC, d = d0 + c, kpos = k0 + r;
        kc[r * (WDC + 1) + c] = (kpos < a.T && d < D)
            ? to_f(vg[(long long)kpos * a.vs.s + d]) : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < WBQ * WDC; i += THREADS) {
        const int r = i / WDC, c = i % WDC, d = d0 + c;
        if (d >= D) continue;
        float o = acc[r * D + d] * ra[r];
#pragma unroll 8
        for (int j = 0; j < WBK; ++j) o += sc[r * WBK + j] * kc[j * (WDC + 1) + c];
        acc[r * D + d] = o;
      }
    }
  }
  __syncthreads();
  T* og = (T*)a.o;
  for (int i = tid; i < WBQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qpos = q0 + r;
    if (qpos < a.S)
      from_f(og + (((size_t)b * a.S + qpos) * a.H + h) * D + d,
             acc[i] / fmaxf(rl[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// head dims above 256: flash_fwd_wide, its accumulator in shared memory
// where it fits (else in acc, ceil(S / 16) * 16 * H * B * D floats)
int launch_wide(const Args& a, int D, int dtype, float* acc,
                cudaStream_t st) {
  const dim3 grid((a.S + WBQ - 1) / WBQ, a.H, a.B);
  const size_t smem = wide_smem(D, acc == nullptr);
  if (dtype == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_wide<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    flash_fwd_wide<float><<<grid, THREADS, smem, st>>>(a, D, acc);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_wide<bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    flash_fwd_wide<bf16><<<grid, THREADS, smem, st>>>(a, D, acc);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Args& a, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_fwd_f32<D>, dim3((a.S + 31) / 32, a.H, a.B),
                  sizeof(float) * (32 * D + D * (BK + 1) + BK * D + 4 * 8 * BK),
                  a, st);
  if (a.kv_splits == 0) {
    constexpr int BQ = 64 * RowTiles<D>::MT;
    return launch(flash_fwd_mma<D>, dim3((a.S + BQ - 1) / BQ, a.H, a.B),
                  2 * (BQ * D + 2 * 2 * BK * D), a, st);
  }
  constexpr int ST = D >= 128 ? 3 : 4;
  return launch(flash_decode_mma<D, ST>, dim3(a.B * a.KV, a.kv_splits),
                2 * (DECODE_ROWS * D + ST * 2 * BK * D), a, st);
}

}  // namespace

// q (B, S, H, D), k and v (B, T, KV, D), each with element strides
// (batch, position, head); o (B, S, H, D) contiguous. dtype: 0 = float32,
// 1 = bfloat16; D in {16, 64, 128, 256}, or any multiple of 8 above 256
// (flash_fwd_wide, kv_splits 0; part: null, or where its accumulator does
// not fit shared memory, wide_acc_floats of scratch). kv_splits: 0 for the 64-row kernel; for
// bf16 with (H / KV) * S <= 16, n >= 1 for the decode kernel with T split
// over n blocks (n > 1 needs part, B*KV*n*16*(D+2) floats, and counters, B*KV
// ints at zero). scale multiplies the scores: 1/sqrt(D) where it is 0, the
// original head dim's 1/sqrt where q, k and v were zero-padded up to D.
// Returns the CUDA error of the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int KV, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int dtype, int causal, int kv_splits,
    float scale, void* part, void* counters, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // the split merge keeps kv_splits x 16 (m, l) pairs in the decode
  // kernel's shared memory: 16 KB at 128, within its smallest (D = 16)
  // allocation
  if (kv_splits < 0 || kv_splits > 128 ||
      (kv_splits > 0 && (dtype != 1 || (H / KV) * S > DECODE_ROWS)) ||
      (kv_splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // every row is read 16 bytes at a time
  const long long es = dtype == 0 ? 4 : 2;
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_st,
                                k_sh, v_sb, v_st, v_sh};
  long long bad = (long long)(((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                               (uintptr_t)o) & 15u);
  for (int i = 0; i < 9; ++i) bad |= (strides[i] * es) & 15;
  if (bad) return (int)cudaErrorMisalignedAddress;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.S = S;
  a.T = T;
  a.H = H;
  a.KV = KV;
  a.qs = Strides{q_sb, q_ss, q_sh};
  a.ks = Strides{k_sb, k_st, k_sh};
  a.vs = Strides{v_sb, v_st, v_sh};
  a.causal = causal ? 1 : 0;
  a.kv_splits = kv_splits;
  a.part = (float*)part;
  a.counters = (int*)counters;
  a.scale = scale > 0.0f ? scale : 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  if (D > 256) {
    if (D % 8 != 0 || kv_splits != 0) return (int)cudaErrorInvalidValue;
    return launch_wide(a, D, dtype, (float*)part, st);
  }
  switch (D) {
    case 16:
      return launch_d<16>(a, dtype, st);
    case 64:
      return launch_d<64>(a, dtype, st);
    case 128:
      return launch_d<128>(a, dtype, st);
    case 256:
      return launch_d<256>(a, dtype, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Whether flash_fwd_wide keeps its accumulator at head dim D in shared
// memory (1), or needs part (0).
extern "C" int flash_wide_in_smem(int D) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return wide_smem(D, true) <= (size_t)optin ? 1 : 0;
}
