// GQA decode attention: one new token per sequence against its KV cache,
// the sequence split across the CTAs of a thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py ::
// decode_attention_pallas (its `_kernel`).  For every batch row b and query
// head h of group G = Hq / Hkv:
//
//   out[b, h] = softmax(q[b, h] . K[b, :len_b, h/G]^T * D^-1/2)
//               . V[b, :len_b, h/G]
//
// with scores, maxima, sums and accumulators in float32, folded with the
// TPU kernel's online-softmax step and its isinf guards, and out =
// acc / max(l, 1e-30), so an empty row (len_b = 0) gives 0.  Any group
// G >= 1, as the TPU kernel's (1, 1, G, D) query block takes: a CTA
// computes one tile of at most kMaxGroup = 8 query heads of one KV head,
// and a KV head has ceil(G / 8) tiles.
//
// Bound on the H100: bytes.  The valid K/V rows are read once (2 * len_b *
// D * sizeof(kv) per KV head); each row is used by G query heads, ~2G
// operations a byte in bf16, far under the card's ~295 operations a byte.
// So the design is about bytes in flight on every SM.  Above G = 8 each
// head tile reads the rows again: ceil(G / 8) times in all (twice at
// recurrentgemma-9b's G = 16), from L2 when the tiles of one KV head run
// together (they are adjacent along grid y).
//
// Design (flash-decoding inside one launch).  The grid is (splits,
// Hkv * ceil(G / 8), B), launched as clusters of `splits` CTAs along x;
// blockIdx.y = KV head * tiles + head tile.  The capacity S is cut
// into tiles of 2048 bytes of K per KV head (at least 16 rows on the
// tensor cores); CTA c of a cluster owns the whole tiles
// [c*T/splits, (c+1)*T/splits) of the T tiles, clipped at len_b, so no
// split is empty by capacity when splits <= T, and a split wholly past
// len_b reads nothing and contributes (m, l, acc) = (-inf, 0, 0).  Inside a
// CTA each of its four warps takes every fourth tile and folds it into its
// own online-softmax state (base 2), with no block barrier in the loop: the
// warp copies its tiles' K and V rows with cp.async (16 bytes a lane,
// zero-filled past the end) into its own ring in shared memory, and
// cp.async.wait_group plus __syncwarp order the ring.
//
// - bfloat16 q and KV (the serving path): the two products run on the
//   tensor cores, mma.sync m16n8k16 with float32 accumulation, the G query
//   heads as rows of a 16-row A, K and V read from the ring with ldmatrix;
//   P stays in registers (the scores' accumulator layout is P's operand
//   layout) and keeps float32 accuracy as a bf16 high plus a bf16 low half.
//   A two-stage ring of padded rows, 39 KB a CTA at D = 64: five CTAs a SM.
// - float32 q (float32 or bfloat16 KV): CUDA-core FMAs in float32 (TF32
//   would not hold the float32 tolerance).  A lane owns one 16-byte slice
//   of D of a few rows, its query slice in registers, and reads back only
//   the slices it copied; the lanes of a row sum their scores with
//   shuffles; a three-stage ring.
//
// At the end the warps of a CTA merge their partials through shared memory
// (one block barrier); after a cluster barrier each CTA reads its peers'
// partials through distributed shared memory, merges them in rank order (so
// the result does not depend on timing) for its share of the G x D outputs,
// and writes them; a second cluster barrier keeps every CTA's shared memory
// alive until its peers have read it.  No global workspace, no atomics, no
// second kernel.  The cache is read in place in its [B, S, Hkv, D] layout
// at any batch and sequence stride.
//
// Split rule (kernel.py num_splits, from shapes only, never from lengths):
// splits in {1, 2, 4, 8}, doubled until the CTAs cover the SMs, then only
// while they stay within one wave (four a SM) and each split keeps 2048
// rows of S; never more than the tiles of S.  On the H100 that gives 4 at
// the Llama decode shape and 2 at B=32, S=32768 (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;          // a warp's ring depth, CUDA-core kernel
constexpr int kStepBytes = 2048;    // K bytes of one KV head a warp step
constexpr int kMaxGroup = 8;        // query heads of one CTA (a head tile)
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kPartHead = 2 * kMaxGroup;   // m[8], l[8] before acc

using bf16 = __nv_bfloat16;


template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 16-byte async copy; with ok == false nothing is read and zeros land
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TKV>
__device__ __forceinline__ void load16(const unsigned char* src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const unsigned char* src,
                                              float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
}
template <>
__device__ __forceinline__ void load16<bf16>(const unsigned char* src,
                                             float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x, dst[2 * i + 1] = f.y;
  }
}

// weight of a partial with maximum m (log2 units) in a merge whose
// maximum is m_safe
__device__ __forceinline__ float merge_weight(float m, float m_safe) {
  return isinf(m) ? 0.f : exp2f(m - m_safe);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}
// c += a . b, m16n8k16, bf16 in, float32 accumulate; a1 = a3 = 0 (rows
// 8..15 of A are padding)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <typename TKV, int D, int GM>
struct Cfg {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));
  static constexpr int kRowChunks = kRowBytes / 16;
  // lanes that share a row, and 16-byte chunks of it each lane owns
  static constexpr int kLpr = kRowChunks < 32 ? kRowChunks : 32;
  static constexpr int kCpl = kRowChunks / kLpr;
  static constexpr int kSlots = 32 / kLpr;      // rows one warp op covers
  static constexpr int kStepRows = kStepBytes / kRowBytes;   // tile rows
  static constexpr int kRpl = kStepRows / kSlots;            // rows a lane
  static constexpr int kEpl = kCpl * kVec;      // elements of D a lane
  static constexpr int kLaneChunks = kRpl * kCpl;
  static constexpr int kHalf = kLaneChunks * 32 * 16;  // K (or V) a stage
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kPart = kPartHead + GM * D;  // floats of a partial
  static constexpr size_t kSmem =
      static_cast<size_t>(kRing) + sizeof(float) * kPart;
  // four CTAs a SM (128 registers) for groups up to 4; a group of 8
  // needs more registers than that without spilling
  static constexpr int kMinBlocks = GM == 8 ? 2 : 4;
  static_assert(kRowChunks >= 1 && kRowChunks % kLpr == 0, "row chunks");
  static_assert(kSlots * kRpl == kStepRows && kRpl >= 1, "step rows");
  static_assert(sizeof(float) * kPart <= kStages * kStage,
                "a warp's partial fits its ring");
};

// Every warp has left its partial (m[8], l[8], acc[G][D], log2 units; G
// the heads of the CTA's tile) at the start of its own `warp_bytes` of
// shared memory.  Merge them in warp order into the CTA's partial `cp`,
// then, across the cluster, merge the CTAs' partials in rank order for
// this CTA's share of the G x D outputs and store them at out + q0.
template <typename TKV, int D>
__device__ __forceinline__ void merge_store(const unsigned char* smem,
                                            int warp_bytes, float* cp, int G,
                                            TKV* __restrict__ out,
                                            int64_t q0, int split,
                                            int splits) {
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();

  // the CTA's partial: its warps merged in warp order
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, reinterpret_cast<const float*>(
                         smem + w * warp_bytes)[g]);
    const float ms = isinf(mx) ? 0.f : mx;
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw =
          reinterpret_cast<const float*>(smem + w * warp_bytes);
      const float wt = merge_weight(pw[g], ms);
      ls += wt * pw[kMaxGroup + g];
      a += wt * pw[kPartHead + idx];
    }
    cp[kPartHead + idx] = a;
    if (idx % D == 0) {
      cp[g] = mx;
      cp[kMaxGroup + g] = ls;
    }
  }
  cluster.sync();   // every CTA's partial is visible to the cluster

  // this CTA's share of the outputs: the cluster's partials merged in rank
  // order, read through distributed shared memory
  const int per = (G * D + splits - 1) / splits;
  const int hi = min(G * D, (split + 1) * per);
  for (int idx = split * per + threadIdx.x; idx < hi; idx += kThreads) {
    const int g = idx / D;
    float mx = -INFINITY;
    for (int j = 0; j < splits; ++j)
      mx = fmaxf(mx, cluster.map_shared_rank(cp, j)[g]);
    const float ms = isinf(mx) ? 0.f : mx;
    float ls = 0.f, a = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float* pj = cluster.map_shared_rank(cp, j);
      const float wt = merge_weight(pj[g], ms);
      ls += wt * pj[kMaxGroup + g];
      a += wt * pj[kPartHead + idx];
    }
    out[q0 + idx] = from_f32<TKV>(a / fmaxf(ls, 1e-30f));
  }
  cluster.sync();   // no CTA leaves while a peer reads its partial
}

template <typename TQ, typename TKV, int D, int GM>
__global__ void __launch_bounds__(kThreads, (Cfg<TKV, D, GM>::kMinBlocks))
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        TKV* __restrict__ out, int S, int G, int64_t k_sb,
                        int64_t k_ss, int64_t v_sb, int64_t v_ss,
                        float scale_log2) {
  using C = Cfg<TKV, D, GM>;
  constexpr int LPR = C::kLpr, CPL = C::kCpl, SLOTS = C::kSlots;
  constexpr int RPL = C::kRpl, EPL = C::kEpl, VEC = C::kVec;
  constexpr int ROWS = C::kStepRows;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int splits = gridDim.x;
  const int split = static_cast<int>(cluster.block_rank());
  // this CTA's head tile: query heads [g0, g0 + GT) of KV head h
  const int n_tiles = (G + kMaxGroup - 1) / kMaxGroup;
  const int h = blockIdx.y / n_tiles, b = blockIdx.z;
  const int hkv = gridDim.y / n_tiles, g0 = blockIdx.y % n_tiles * kMaxGroup;
  const int GT = min(kMaxGroup, G - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = lane % LPR, slot = lane / LPR;
  const int len = min(max(lengths[b], 0), S);
  const int64_t q0 =
      (static_cast<int64_t>(b) * hkv * G + static_cast<int64_t>(h) * G + g0) *
      D;
  const TKV* kb = k + b * k_sb + static_cast<int64_t>(h) * D;
  const TKV* vb = v + b * v_sb + static_cast<int64_t>(h) * D;

  // this CTA's tiles [t0, t1) of the capacity, clipped at len_b; this
  // warp's tiles are t0 + warp, t0 + warp + kWarps, ...
  const int64_t tiles = (S + ROWS - 1) / ROWS;
  const int t0 = static_cast<int>(split * tiles / splits);
  const int t1 = static_cast<int>((split + 1) * tiles / splits);
  const int row_end = min(len, t1 * ROWS);
  const int avail = row_end > t0 * ROWS
                        ? (row_end - t0 * ROWS + ROWS - 1) / ROWS : 0;
  const int n_mine = avail > warp ? (avail - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + warp * kStages * C::kStage;

  float qr[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][c * VEC + e] =
            g < GT ? q[q0 + g * D + (c * LPR + part) * VEC + e] : 0.f;
  float m[GM], l[GM], acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // start the copies of this warp's i-th tile into ring slot i % kStages:
  // row r*SLOTS + slot of the tile, chunks c*LPR + part; rows past
  // row_end are zero-filled from a valid address and never read
  auto start_copies = [&](int i) {
    const int row0 = (t0 + warp + i * kWarps) * ROWS;
    const int nrows = min(ROWS, row_end - row0);
    unsigned char* st = ring + (i % kStages) * C::kStage;
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int lr = r * SLOTS + slot;
      const bool ok = lr < nrows;
      const int64_t row = row0 + (ok ? lr : 0);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = (c * LPR + part) * VEC;
        const int off = ((r * CPL + c) * 32 + lane) * 16;
        cp_async16(st + off, kb + row * k_ss + col, ok);
        cp_async16(st + C::kHalf + off, vb + row * v_ss + col, ok);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_mine) start_copies(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    if (i + kStages - 1 < n_mine) start_copies(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this lane's copies of tile i landed
    const unsigned char* st = ring + (i % kStages) * C::kStage;
    const int nrows = min(ROWS, row_end - (t0 + warp + i * kWarps) * ROWS);

    float s[RPL][GM];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      float kf[EPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        load16<TKV>(st + ((r * CPL + c) * 32 + lane) * 16, kf + c * VEC);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kf[e], a);
        s[r][g] = a;
      }
    }
    // the lanes of a row add their slices: every one of them holds the
    // row's scores
#pragma unroll
    for (int r = 0; r < RPL; ++r)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < GT) {
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], o);
        }
    // online softmax of this lane group's rows (the TPU kernel's step)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < GT) {
        float mt = -INFINITY;
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          s[r][g] = r * SLOTS + slot < nrows ? s[r][g] * scale_log2 : -INFINITY;
          mt = fmaxf(mt, s[r][g]);
        }
        const float m_new = fmaxf(m[g], mt);
        const float m_safe = isinf(m_new) ? 0.f : m_new;
        const float corr = merge_weight(m[g], m_safe);
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          s[r][g] = isinf(s[r][g]) ? 0.f : exp2f(s[r][g] - m_safe);
          sum += s[r][g];
        }
        m[g] = m_new;
        l[g] = l[g] * corr + sum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
      }
    }
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      float vf[EPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        load16<TKV>(st + C::kHalf + ((r * CPL + c) * 32 + lane) * 16,
                    vf + c * VEC);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < GT) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(s[r][g], vf[e], acc[g][e]);
        }
    }
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (a butterfly: every lane ends with
  // the same sums, since a + b == b + a in floating point)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < GT) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float ms = isinf(mn) ? 0.f : mn;
        const float w1 = merge_weight(m[g], ms), w2 = merge_weight(mo, ms);
        m[g] = mn;
        l[g] = l[g] * w1 + lo * w2;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * w1 + ao * w2;
        }
      }
    }
  }
  // the warp's partial goes into its own ring, which it no longer reads
  __syncwarp();
  float* wp = reinterpret_cast<float*>(ring);
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < GT) {
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            wp[kPartHead + g * D + (c * LPR + part) * VEC + e] =
                acc[g][c * VEC + e];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      wp[g] = m[g];
      wp[kMaxGroup + g] = l[g];
    }
  }
  merge_store<TKV, D>(smem, kStages * C::kStage,
                      reinterpret_cast<float*>(smem + C::kRing), GT, out, q0,
                      split, splits);
}

// The bfloat16 instantiation on the tensor cores.  A warp step is
// kRows keys (2048 bytes of K, at least 16 rows), copied by the whole warp
// as [kRows][D] row-major tiles with rows padded by 16 bytes (the ldmatrix
// reads of eight rows hit eight distinct bank groups), in a two-stage ring
// (with five CTAs resident a SM, that keeps enough bytes in flight).
// S = Q K^T and O += P V are mma.sync m16n8k16 products with float32
// accumulation; the tile's GT <= 8 query heads are rows 0..GT-1 of a 16-row
// A (rows 8..15 are zero).  Lane (g = lane / 4, t = lane % 4) holds the scores of head g
// at keys 2t, 2t+1 of each 8-key block, the layout of P's A fragment, so P
// never leaves registers; P keeps float32 accuracy as a bf16 high half plus
// a bf16 low half, two products.
template <int D>
struct MmaCfg {
  static constexpr int kRows =
      kStepBytes / (2 * D) > 16 ? kStepBytes / (2 * D) : 16;
  static constexpr int kRS = 2 * D + 16;          // padded row (bytes)
  static constexpr int kChunks = D / 8;           // 16-byte chunks a row
  static constexpr int kHalf = kRows * kRS;       // K (or V) a stage
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kStages = 2;
  static constexpr int kWarpBytes = kStages * kStage;
  static constexpr int kRing = kWarps * kWarpBytes;
  static constexpr int kPart = kPartHead + kMaxGroup * D;
  static constexpr size_t kSmem =
      static_cast<size_t>(kRing) + sizeof(float) * kPart;
  static constexpr int kMinBlocks = D <= 64 ? 5 : (D <= 128 ? 2 : 1);
  static_assert(sizeof(float) * kPart <= kWarpBytes,
                "a warp's partial fits its ring");
  static_assert(kRows % 16 == 0, "whole 16-key steps");
};

template <int D>
__global__ void __launch_bounds__(kThreads, MmaCfg<D>::kMinBlocks)
decode_attention_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int32_t* __restrict__ lengths,
                            bf16* __restrict__ out, int S, int G,
                            int64_t k_sb, int64_t k_ss, int64_t v_sb,
                            int64_t v_ss, float scale_log2) {
  using C = MmaCfg<D>;
  constexpr int ROWS = C::kRows, RS = C::kRS, NB = ROWS / 8;
  constexpr int KD = D / 16, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int splits = gridDim.x;
  const int split = static_cast<int>(cluster.block_rank());
  // this CTA's head tile: query heads [g0, g0 + GT) of KV head h
  const int n_tiles = (G + kMaxGroup - 1) / kMaxGroup;
  const int h = blockIdx.y / n_tiles, b = blockIdx.z;
  const int hkv = gridDim.y / n_tiles, g0 = blockIdx.y % n_tiles * kMaxGroup;
  const int GT = min(kMaxGroup, G - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(max(lengths[b], 0), S);
  const int64_t q0 =
      (static_cast<int64_t>(b) * hkv * G + static_cast<int64_t>(h) * G + g0) *
      D;
  const bf16* kb = k + b * k_sb + static_cast<int64_t>(h) * D;
  const bf16* vb = v + b * v_sb + static_cast<int64_t>(h) * D;

  const int64_t tiles = (S + ROWS - 1) / ROWS;
  const int t0 = static_cast<int>(split * tiles / splits);
  const int t1 = static_cast<int>((split + 1) * tiles / splits);
  const int row_end = min(len, t1 * ROWS);
  const int avail = row_end > t0 * ROWS
                        ? (row_end - t0 * ROWS + ROWS - 1) / ROWS : 0;
  const int n_mine = avail > warp ? (avail - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + warp * C::kWarpBytes;

  // head g's query as A fragments: a0 = d 16kk + 2t, +1; a2 = d + 8
  uint32_t qa[KD][2];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      qa[kk][j] = g < GT ? *reinterpret_cast<const uint32_t*>(
                              q + q0 + g * D + 16 * kk + 8 * j + 2 * t)
                        : 0u;
  float m_r = -INFINITY, l_r = 0.f;   // head g; l_r: this lane's keys
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  auto start_copies = [&](int i) {
    const int row0 = (t0 + warp + i * kWarps) * ROWS;
    const int nrows = min(ROWS, row_end - row0);
    unsigned char* st = ring + (i % C::kStages) * C::kStage;
#pragma unroll
    for (int idx = lane; idx < ROWS * C::kChunks; idx += 32) {
      const int r = idx / C::kChunks, c = idx % C::kChunks;
      const bool ok = r < nrows;
      const int64_t row = row0 + (ok ? r : 0);
      cp_async16(st + r * RS + c * 16, kb + row * k_ss + c * 8, ok);
      cp_async16(st + C::kHalf + r * RS + c * 16, vb + row * v_ss + c * 8,
                 ok);
    }
  };

  if (n_mine > 0) start_copies(0);
  cp_async_commit();
  for (int i = 0; i < n_mine; ++i) {
    __syncwarp();   // every lane is done with the slot the copies refill
    if (i + 1 < n_mine) start_copies(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();   // every lane's copies of tile i are visible
    const unsigned char* ks = ring + (i % C::kStages) * C::kStage;
    const unsigned char* vs = ks + C::kHalf;
    const int nrows = min(ROWS, row_end - (t0 + warp + i * kWarps) * ROWS);

    // S = Q K^T, 8 keys a block: sc[jb][0..1] = head g, keys 8jb + 2t, +1
    float sc[NB][4];
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
      sc[jb][0] = sc[jb][1] = sc[jb][2] = sc[jb][3] = 0.f;
#pragma unroll
    for (int jb = 0; jb < NB; jb += 2) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (8 * (jb + (lane >> 4)) + (lane & 7)) * RS +
                            (16 * kk + 8 * ((lane >> 3) & 1)) * 2);
        mma_bf16(sc[jb], qa[kk][0], qa[kk][1], bk[0], bk[1]);
        mma_bf16(sc[jb + 1], qa[kk][0], qa[kk][1], bk[2], bk[3]);
      }
    }
    // online softmax of head g (log2 units), the TPU kernel's step; the
    // four lanes of a head agree on its maximum
    float mt = -INFINITY;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = 8 * jb + 2 * t + e < nrows ? sc[jb][e] * scale_log2
                                                   : -INFINITY;
        sc[jb][e] = x;
        mt = fmaxf(mt, x);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_r, mt);
    const float m_safe = isinf(m_new) ? 0.f : m_new;
    const float corr = merge_weight(m_r, m_safe);
    float sum = 0.f;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[jb][e] = isinf(sc[jb][e]) ? 0.f : exp2f(sc[jb][e] - m_safe);
        sum += sc[jb][e];
      }
    m_r = m_new;
    l_r = l_r * corr + sum;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }
    // O += P V, 16 keys a step; P = hi + lo in bf16
#pragma unroll
    for (int kb2 = 0; kb2 < ROWS / 16; ++kb2) {
      uint32_t ph[2], pl[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x0 = sc[2 * kb2 + j][0], x1 = sc[2 * kb2 + j][1];
        const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
        ph[j] = pack_bf16(h0, h1);
        pl[j] = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                          __float2bfloat16(x1 - __bfloat162float(h1)));
      }
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, vs + (16 * kb2 + 8 * ((lane >> 3) & 1) + (lane & 7)) * RS +
                    8 * (n + (lane >> 4)) * 2);
        mma_bf16(o[n], ph[0], ph[1], bv[0], bv[1]);
        mma_bf16(o[n], pl[0], pl[1], bv[0], bv[1]);
        mma_bf16(o[n + 1], ph[0], ph[1], bv[2], bv[3]);
        mma_bf16(o[n + 1], pl[0], pl[1], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 1);
  l_r += __shfl_xor_sync(0xffffffffu, l_r, 2);

  // the warp's partial goes into its own ring, which it no longer reads
  __syncwarp();
  float* wp = reinterpret_cast<float*>(ring);
  if (g < GT) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      wp[kPartHead + g * D + 8 * n + 2 * t] = o[n][0];
      wp[kPartHead + g * D + 8 * n + 2 * t + 1] = o[n][1];
    }
    if (t == 0) {
      wp[g] = m_r;
      wp[kMaxGroup + g] = l_r;
    }
  }
  merge_store<bf16, D>(smem, C::kWarpBytes,
                       reinterpret_cast<float*>(smem + C::kRing), GT, out, q0,
                       split, splits);
}

// head tiles of one KV head: CTAs of at most kMaxGroup query heads
inline int head_tiles(int g) { return (g + kMaxGroup - 1) / kMaxGroup; }

// one call's arguments; max_clusters != nullptr asks for the occupancy
// (cudaOccupancyMaxActiveClusters) instead of a launch
struct Args {
  const void *q, *k, *v, *lengths;
  void* out;
  int b, s, hkv, g;
  int64_t k_sb, k_ss, v_sb, v_ss;
  float scale_log2;
  int splits;
  cudaStream_t stream;
  int* max_clusters;
};

template <typename TQ, typename TKV, int D, int GM>
cudaError_t launch(const Args& a) {
  // bfloat16 q and KV on the tensor cores; float32 on the CUDA cores
  constexpr bool kMma =
      std::is_same<TQ, bf16>::value && std::is_same<TKV, bf16>::value;
  auto kernel = [] {
    if constexpr (kMma)
      return decode_attention_mma_kernel<D>;
    else
      return decode_attention_kernel<TQ, TKV, D, GM>;
  }();
  size_t smem;
  if constexpr (kMma)
    smem = MmaCfg<D>::kSmem;
  else
    smem = Cfg<TKV, D, GM>::kSmem;
  static bool configured = false;   // the attribute is set once a kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.hkv * head_tiles(a.g), a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(a.max_clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
      static_cast<const int32_t*>(a.lengths), static_cast<TKV*>(a.out), a.s,
      a.g, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale_log2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV, int GM>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch<TQ, TKV, 16, GM>(a);
    case 32: return launch<TQ, TKV, 32, GM>(a);
    case 64: return launch<TQ, TKV, 64, GM>(a);
    case 128: return launch<TQ, TKV, 128, GM>(a);
    case 256: return launch<TQ, TKV, 256, GM>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t dispatch_g(int d, const Args& a) {
  // the CUDA-core kernel's register arrays are sized for the head tile: 4
  // query heads (G <= 4, one tile) or 8 (the tensor-core kernel pads a
  // tile to 16 rows)
  if (a.g <= 4 && !std::is_same<TQ, bf16>::value)
    return dispatch_d<TQ, TKV, 4>(d, a);
  return dispatch_d<TQ, TKV, 8>(d, a);
}

cudaError_t dispatch(int d, int q_bf16, int kv_bf16, const Args& a) {
  if (a.g < 1 || a.b < 1 || a.b > 65535 || a.hkv < 1 ||
      static_cast<int64_t>(a.hkv) * head_tiles(a.g) > 65535 || a.s < 0 ||
      a.splits < 1 || a.splits > kMaxSplits ||
      (a.splits & (a.splits - 1)) != 0)
    return cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16) return dispatch_g<bf16, bf16>(d, a);
  if (kv_bf16) return dispatch_g<float, bf16>(d, a);
  if (q_bf16) return cudaErrorInvalidValue;
  return dispatch_g<float, float>(d, a);
}

}  // namespace

// q [B, Hkv*G, D] contiguous; k, v [B, S, Hkv, D] with unit element stride,
// head stride D and batch/seq strides (in elements) as given, 16-byte
// aligned rows; lengths [B] int32 on the device; out [B, Hkv*G, D]
// contiguous, of the KV dtype; scale_log2 is log2(e) * D^-1/2 as float32
// (the softmax runs in base 2).  q_bf16 / kv_bf16 select bfloat16 (else
// float32): q and KV of one dtype, or a float32 q against a bfloat16 cache
// (the int8-KV path loads as bfloat16); a bfloat16 q against a float32
// cache has no caller and is refused.
// D in {16, 32, 64, 128, 256}, G >= 1 with Hkv * ceil(G / 8) <= 65535,
// splits in {1, 2, 4, 8} (the cluster size).  Launches on `stream`; returns the launch's cudaError
// (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int b, int s, int hkv,
                                       int g, int d, long long k_sb,
                                       long long k_ss, long long v_sb,
                                       long long v_ss, float scale_log2,
                                       int q_bf16, int kv_bf16, int splits,
                                       void* stream) {
  const Args a{q, k, v, lengths, out, b, s, hkv, g, k_sb, k_ss, v_sb, v_ss,
               scale_log2, splits, static_cast<cudaStream_t>(stream),
               nullptr};
  return static_cast<int>(dispatch(d, q_bf16, kv_bf16, a));
}

// How many clusters of `splits` CTAs of the kernel for (d, g, dtypes) the
// card holds at once (cudaOccupancyMaxActiveClusters) for a grid of
// (splits, hkv * ceil(g / 8), b), into *clusters; returns the cudaError.
extern "C" int decode_attention_max_clusters(int b, int hkv, int g, int d,
                                             int q_bf16, int kv_bf16,
                                             int splits, int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, b, 1, hkv, g,
               0, 0, 0, 0, 1.f, splits, nullptr, clusters};
  return static_cast<int>(dispatch(d, q_bf16, kv_bf16, a));
}
