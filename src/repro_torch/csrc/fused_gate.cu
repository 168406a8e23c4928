// Fused admission gate for the Data Engine's Rate Limiter (FENIX §4.2).
//
// Replaces the TPU kernel src/repro/kernels/rate_gate/kernel.py ::
// fused_gate_pallas in both its variants: rand-input (_kernel_fused_randin,
// `fused_gate_launch`) and on-core PRNG (_kernel_fused_prng,
// `fused_gate_prng_launch`), with _fused_body and _lut_lookup, and the
// batch-start register derivation of src/repro/kernels/rate_gate/ops.py ::
// fused_admission.  Per packet i of one batch:
//
//   t_ref     = t_last == 0 ? ts_0 : t_last
//   burst0    = min(bucket, bucket_cap_us)
//   prob_i    = lut[clip(t_i >> t_shift), clip(c_i >> c_shift)]
//   sel_i     = rand16_i < prob_i
//   spend_i   = sum_{j <= i} sel_j * cost_us         (int32, wrapping)
//   credit_i  = burst0 + max(ts_i - t_ref, 0)
//   granted_i = sel_i && spend_i <= credit_i
//   bucket'   = clip(credit_{n-1} - n_granted * cost_us, 0, bucket_cap_us)
//
// rand16_i is read from memory (rand-input) or drawn in registers from
// the chunk's threefry subkey (gate_common.cuh).  The TPU's on-core bits
// cannot be reproduced off a TPU and were promised only in distribution;
// keyed to the chunk's threefry stream, the drawn variant is bit-exact
// with the rand-input one fed prng.randint(key, n, 0, 2^prob_bits).  The
// int32 sums wrap as XLA's do: they are taken in uint32 and cast back.
//
// Bound on the H100: bytes.  A batch reads four int32 lanes per packet
// (three when drawing) and the 8 KB LUT, and writes one byte per packet:
// 17 bytes a lane, 70 KB at 4096 lanes (21 ns at 3.35 TB/s) and 17.8 MB
// at 2^20 (5.3 us).  The draw adds ~120 integer operations a lane, under
// the bytes' time.  Up to a few thousand lanes the work is one dependent
// scan, and latency sets the time: one launch, one load round trip, the
// scan's barriers (the kernel's time at n = 1, which chip_smoke.py times),
// each thread's chain of dependent steps, and how much one SM issues.
//
// Design.  The TPU kernel evaluates the lookup as a one-hot MXU matmul and
// carries the spend across a sequential grid in SMEM; neither carries
// over.
// - Every load is in flight before anything waits: the LUT's copy into
//   shared memory by cp.async, the batch-start registers, and each
//   thread's consecutive lanes, one vector load an array where the arrays
//   are aligned (4-byte loads, masked, where not, and at the ragged end).
//   The drawing variant draws its lanes meanwhile.  One barrier publishes
//   the LUT.
// - In a CTA: a serial sum over the thread's lanes (one or two), a warp
//   scan by __shfl_up_sync and a scan of the warp totals (one barrier);
//   the grant count by warp reduction.
// - One CTA alone up to 1024 lanes (2048 drawing).  Up to kClusterLanes
//   (the main path's 4096): one thread-block cluster of up to eight CTAs,
//   one an SM.  Each CTA writes its spend into the shared memory of every
//   higher rank and its warps' grant counts into the last rank's
//   (distributed shared memory); two cluster barriers order them.  No
//   scratch, no global atomics, nothing to zero.  The thread that owns
//   lane n-1 writes the bucket level from the timestamp it holds.
// - Above (n > kClusterLanes): CTAs of kTileLanes lanes take their tiles
//   from a ticket, so a CTA only ever waits on tiles already running, and
//   the spend crosses tiles by decoupled look-back over per-tile status
//   words (flag and value in one 64-bit word).  The grant total is an
//   integer atomicAdd, exact whatever the timing; the last CTA to finish
//   (a second ticket) writes the bucket level.  Tickets and status words
//   live in a scratch buffer that the launcher zeroes with one memset.
// - Pipes.  The multi-pipe driver admits the batches of its P pipes in one
//   launch (the reference's vmap over pipes gives its pallas_call a grid
//   axis of pipes): lanes [P, n], LUTs [P, TB, CB], registers [P], keys
//   [P, 2], outputs [P, n] and [P].  blockIdx.y is the pipe; each CTA
//   offsets every pointer to its pipe's row (its own LUT copy in shared
//   memory, its own registers and key), and each pipe's look-back has its
//   own tickets and status words at a pipe offset in the scratch.  A
//   cluster spans the CTAs of one pipe ((k, 1, 1) cluster dims).  One pipe
//   is the single batch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gate_common.cuh"

namespace {

namespace cg = cooperative_groups;
using fenix_gate::clampi;

constexpr unsigned kFull = 0xffffffffu;

// A batch of up to kClusterLanes lanes is one CTA or one cluster of up
// to kClusterMax CTAs of at most kCtaThreads threads, kLanes consecutive
// lanes a thread: few lanes a thread keep each thread's chain of loads,
// lookups, draws and credit checks short, and spreading a batch over up to
// eight SMs (each CTA at least kCtaMinLanes lanes) cuts what each SM
// issues; together these set the time at the main path's sizes.  A larger
// batch is cut into tiles of kTileThreads threads with kTileLanesPerThread
// lanes each.  The sizes are the ones that read fastest on the card.
template <bool kDraw>
struct Shape {
  static constexpr int kLanes = kDraw ? 2 : 1;
  static constexpr int kCtaThreads = kDraw ? 512 : 1024;
  static constexpr int kCtaMinLanes = 512;
  static constexpr int kClusterMax = 8;      // the portable cluster size
  static constexpr int kClusterLanes = kCtaThreads * kLanes * kClusterMax;
  static constexpr int kTileLanesPerThread = 4;
  static constexpr int kTileThreads = 1024;
  static constexpr int kTileLanes = kTileThreads * kTileLanesPerThread;
};

// the look-back's scratch: three uint32 counters (tile ticket, finished
// ticket, grant total) in the first two 64-bit words, then one status word
// per tile: flag << 32 | spend (uint32)
constexpr int kCounterWords = 2;
constexpr uint32_t kFlagAggregate = 1u;      // the tile's own spend
constexpr uint32_t kFlagPrefix = 2u;         // the tile's and all before

struct Args {
  const int32_t* t_i;
  const int32_t* c_i;
  const int32_t* ts;
  const int32_t* rand16;     // rand-input variant
  const int64_t* key;        // drawing variant
  const int32_t* lut;
  const int32_t* bucket;
  const int32_t* t_last;
  uint8_t* granted;
  int32_t* bucket_out;
  unsigned long long* scratch;   // look-back path only
  int scratch_words;             // of one pipe
  int n, tb, cb, t_shift, c_shift;
  uint32_t rand_mask;
  int cost_us, bucket_cap_us;
};

// one thread's lanes
template <int kL>
struct Lanes {
  int t[kL], c[kL], s[kL], r[kL];
};

struct Start {   // the batch-start registers
  int t_ref, burst0;
};

__device__ __forceinline__ void cp_async16(int32_t* smem,
                                           const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A cluster barrier in two halves: every thread arrives at the start and
// waits before its CTA's first access to a peer's shared memory, which
// must not come before every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// flag and value in one 64-bit store: a reader never sees one without the
// other
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             uint32_t flag, uint32_t value) {
  const unsigned long long v =
      (static_cast<unsigned long long>(flag) << 32) | value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// The arguments of pipe p's batch: every pointer offset to its row.
__device__ __forceinline__ Args for_pipe(const Args& g, int p) {
  Args a = g;
  const size_t lanes = static_cast<size_t>(p) * g.n;
  a.t_i += lanes;
  a.c_i += lanes;
  a.ts += lanes;
  if (a.rand16 != nullptr) a.rand16 += lanes;
  if (a.key != nullptr) a.key += 2 * p;
  a.lut += static_cast<size_t>(p) * g.tb * g.cb;
  a.bucket += p;
  a.t_last += p;
  a.granted += lanes;
  a.bucket_out += p;
  if (a.scratch != nullptr)
    a.scratch += static_cast<size_t>(p) * g.scratch_words;
  return a;
}

// The LUT's copy into shared memory: issued here, waited for by
// cp_async_wait_all and published by a barrier.
__device__ __forceinline__ void copy_lut(const Args& a, int32_t* s_lut,
                                         int tid, int threads) {
  const int lut_n = a.tb * a.cb;
  const int lut_v =
      (reinterpret_cast<uintptr_t>(a.lut) & 15) == 0 ? lut_n / 4 : 0;
  for (int i = tid; i < lut_v; i += threads)
    cp_async16(s_lut + 4 * i, a.lut + 4 * i);
  for (int i = 4 * lut_v + tid; i < lut_n; i += threads)
    cp_async4(s_lut + i, a.lut + i);
}

__device__ __forceinline__ Start start_regs(const Args& a) {
  const int bucket = __ldg(a.bucket);
  const int t_last = __ldg(a.t_last);
  const int ts0 = __ldg(a.ts);
  return {t_last == 0 ? ts0 : t_last,
          bucket < a.bucket_cap_us ? bucket : a.bucket_cap_us};
}

// Lanes [g0, g0 + kL) of `x`: one vector load when `vec` (the group is
// whole and x 16-byte aligned), else 4-byte loads masked to n.
template <int kL>
__device__ __forceinline__ void load_lanes(const int32_t* __restrict__ x,
                                           int g0, int n, bool vec,
                                           int (&v)[kL]) {
  if constexpr (kL == 4) {
    if (vec) {
      const int4 y = __ldg(reinterpret_cast<const int4*>(x + g0));
      v[0] = y.x; v[1] = y.y; v[2] = y.z; v[3] = y.w;
      return;
    }
  } else if constexpr (kL == 2) {
    if (vec) {
      const int2 y = __ldg(reinterpret_cast<const int2*>(x + g0));
      v[0] = y.x; v[1] = y.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kL; ++j) v[j] = g0 + j < n ? __ldg(x + g0 + j) : 0;
}

// This thread's lanes and their draws (kDraw) or rand16 values.
template <bool kDraw, int kL>
__device__ __forceinline__ void load_all(const Args& a, int g0, int n_mine,
                                         Lanes<kL>& L) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.t_i) |
                         reinterpret_cast<uintptr_t>(a.c_i) |
                         reinterpret_cast<uintptr_t>(a.ts) |
                         (kDraw ? 0 : reinterpret_cast<uintptr_t>(a.rand16));
  const bool vec = (bits & 15) == 0 && n_mine == kL;
  load_lanes<kL>(a.t_i, g0, a.n, vec, L.t);
  load_lanes<kL>(a.c_i, g0, a.n, vec, L.c);
  load_lanes<kL>(a.ts, g0, a.n, vec, L.s);
  if (kDraw) {
    uint32_t d0 = 0u, d1 = 0u;
    fenix_gate::draw_key(a.key, d0, d1);
#pragma unroll
    for (int j = 0; j < kL; ++j)
      L.r[j] = n_mine > 0 ? fenix_gate::draw_lane(
                                d0, d1, static_cast<uint32_t>(g0 + j),
                                a.rand_mask)
                          : 0;
  } else {
    load_lanes<kL>(a.rand16, g0, a.n, vec, L.r);
  }
}

// bit j: lane g0 + j is selected
template <int kL>
__device__ __forceinline__ uint32_t select_lanes(const Args& a,
                                                 const int32_t* s_lut,
                                                 const Lanes<kL>& L,
                                                 int n_mine) {
  uint32_t sel = 0u;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int prob = fenix_gate::lut_lookup(s_lut, L.t[j], L.c[j], a.tb, a.cb,
                                            a.t_shift, a.c_shift);
    if (j < n_mine && L.r[j] < prob) sel |= 1u << j;
  }
  return sel;
}

// The exclusive prefix of `mine` over the CTA's threads, and the CTA's
// total: a warp scan, then every warp scans the warp totals itself (one
// barrier).
__device__ __forceinline__ uint32_t block_scan(uint32_t mine,
                                               uint32_t* s_warp, int lane,
                                               int warp, int warps,
                                               uint32_t& total) {
  uint32_t incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint32_t w = lane < warps ? s_warp[lane] : 0u;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, w, off);
    if (lane >= off) w += y;
  }
  const uint32_t before = __shfl_sync(kFull, w, (warp + 31) & 31);
  total = __shfl_sync(kFull, w, 31);
  return (warp > 0 ? before : 0u) + incl - mine;
}

// burst0 + max(ts - t_ref, 0) in wrapping int32
__device__ __forceinline__ int credit_at(int ts, Start st) {
  const int gap = static_cast<int>(static_cast<uint32_t>(ts) -
                                   static_cast<uint32_t>(st.t_ref));
  return static_cast<int>(static_cast<uint32_t>(st.burst0) +
                          static_cast<uint32_t>(gap > 0 ? gap : 0));
}

// clip(credit_last - granted * cost_us, 0, cap) in wrapping int32
__device__ __forceinline__ int bucket_level(int credit_last, uint32_t granted,
                                            const Args& a) {
  return clampi(static_cast<int>(static_cast<uint32_t>(credit_last) -
                                 granted * static_cast<uint32_t>(a.cost_us)),
                0, a.bucket_cap_us);
}

// The credit check of this thread's lanes from the spend before them;
// stores the grant bytes (kL at once where whole and aligned) and returns
// them as a mask.  credit_last gets lane n-1's credit where this thread
// holds that lane.
template <int kL>
__device__ __forceinline__ uint32_t grant_lanes(const Args& a,
                                                const Lanes<kL>& L,
                                                uint32_t sel, uint32_t spend,
                                                Start st, int g0, int n_mine,
                                                int& credit_last) {
  static_assert(kL == 1 || kL == 2 || kL == 4, "one store of kL bytes");
  const uint32_t cost = static_cast<uint32_t>(a.cost_us);
  uint32_t got = 0u;
  uint32_t bytes = 0u;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int credit = credit_at(L.s[j], st);
    if (sel >> j & 1u) {
      spend += cost;
      if (static_cast<int>(spend) <= credit) {
        got |= 1u << j;
        bytes |= 1u << (8 * j);
      }
    }
    if (g0 + j == a.n - 1) credit_last = credit;
  }
  uint8_t* out = a.granted + g0;
  if (n_mine == kL && (reinterpret_cast<uintptr_t>(out) & (kL - 1)) == 0) {
    if constexpr (kL == 4)
      *reinterpret_cast<uint32_t*>(out) = bytes;
    else if constexpr (kL == 2)
      *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(bytes);
    else
      *out = static_cast<uint8_t>(bytes);
  } else {
    for (int j = 0; j < n_mine; ++j) out[j] = got >> j & 1u;
  }
  return got;
}

// A batch of up to kClusterLanes lanes: CTA `rank` of a cluster (or the
// one plain CTA) owns lanes [rank * C, (rank + 1) * C), C = blockDim.x *
// kLanes.  Each rank writes its spend into every higher rank's shared
// memory and each warp adds its grant count into the last rank's
// (distributed shared memory); a cluster barrier orders each exchange.
template <bool kDraw>
__global__ void __launch_bounds__(Shape<kDraw>::kCtaThreads)
fused_gate_cluster_kernel(const __grid_constant__ Args g) {
  using S = Shape<kDraw>;
  const Args a = for_pipe(g, blockIdx.y);
  constexpr int kL = S::kLanes;
  extern __shared__ __align__(16) int32_t s_lut[];
  __shared__ uint32_t s_warp[S::kCtaThreads / 32];
  __shared__ uint32_t s_spend[S::kClusterMax];  // [r]: spend of lower rank r
  __shared__ uint32_t s_count;                  // grants (the last rank's)

  // a pipe's row of the grid is its cluster; one CTA alone is launched
  // without one
  const int rank = blockIdx.x;
  const int ranks = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int g0 = (rank * static_cast<int>(blockDim.x) + tid) * kL;
  const int n_mine = clampi(a.n - g0, 0, kL);

  if (ranks > 1) cluster_arrive_relaxed();
  copy_lut(a, s_lut, tid, blockDim.x);
  const Start st = start_regs(a);
  Lanes<kL> L;
  load_all<kDraw, kL>(a, g0, n_mine, L);
  if (tid == 0) s_count = 0u;
  cp_async_wait_all();
  __syncthreads();                               // the LUT

  const uint32_t sel = select_lanes<kL>(a, s_lut, L, n_mine);
  const uint32_t mine =
      static_cast<uint32_t>(__popc(sel)) * static_cast<uint32_t>(a.cost_us);
  uint32_t total;
  uint32_t spend = block_scan(mine, s_warp, lane, warp, warps, total);
  if (ranks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();                              // every CTA has started
    // this CTA's spend into every higher rank
    if (tid > rank && tid < ranks)
      *cluster.map_shared_rank(&s_spend[rank], tid) = total;
    cluster.sync();                              // the lower ranks' spends
    for (int r = 0; r < rank; ++r) spend += s_spend[r];
  }

  int credit_last = 0;
  const uint32_t got = grant_lanes<kL>(a, L, sel, spend, st, g0, n_mine,
                                       credit_last);
  const uint32_t warp_count =
      __reduce_add_sync(kFull, static_cast<uint32_t>(__popc(got)));
  if (ranks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (lane == 0 && warp_count)
      atomicAdd(cluster.map_shared_rank(&s_count, ranks - 1), warp_count);
    cluster.sync();                              // every grant counted
  } else {
    if (lane == 0 && warp_count) atomicAdd(&s_count, warp_count);
    __syncthreads();
  }
  if (g0 <= a.n - 1 && a.n - 1 < g0 + kL)
    a.bucket_out[0] = bucket_level(credit_last, s_count, a);
}

// Decoupled look-back, by one warp: publishes this tile's aggregate, sums
// the spend of all earlier tiles from their status words (32 at a time,
// back to the nearest inclusive prefix), publishes this tile's inclusive
// prefix and returns the exclusive one.
__device__ uint32_t look_back(unsigned long long* status, int tile,
                              uint32_t aggregate, int lane) {
  if (tile == 0) {
    if (lane == 0) store_status(status, kFlagPrefix, aggregate);
    return 0u;
  }
  if (lane == 0) store_status(status + tile, kFlagAggregate, aggregate);
  uint32_t excl = 0u;
  for (int end = tile - 1;; end -= 32) {
    const int p = end - lane;
    unsigned long long s = static_cast<unsigned long long>(kFlagPrefix) << 32;
    if (p >= 0) {
      do {
        s = load_status(status + p);
      } while ((s >> 32) == 0u);
    }
    const unsigned prefix =
        __ballot_sync(kFull, static_cast<uint32_t>(s >> 32) == kFlagPrefix);
    // lanes up to the nearest inclusive prefix contribute
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    excl += __reduce_add_sync(kFull,
                              lane <= stop ? static_cast<uint32_t>(s) : 0u);
    if (prefix) break;
  }
  if (lane == 0) store_status(status + tile, kFlagPrefix, excl + aggregate);
  return excl;
}

// A batch above kClusterLanes lanes: one CTA a tile of kTileLanes lanes,
// the tile by ticket.
template <bool kDraw>
__global__ void __launch_bounds__(Shape<kDraw>::kTileThreads)
fused_gate_lookback_kernel(const __grid_constant__ Args g) {
  using S = Shape<kDraw>;
  const Args a = for_pipe(g, blockIdx.y);
  constexpr int kL = S::kTileLanesPerThread;
  extern __shared__ __align__(16) int32_t s_lut[];
  __shared__ uint32_t s_warp[S::kTileThreads / 32];
  __shared__ uint32_t s_count;   // this tile's grants
  __shared__ uint32_t s_carry;   // spend of all earlier tiles
  __shared__ int s_tile;

  uint32_t* counters = reinterpret_cast<uint32_t*>(a.scratch);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  copy_lut(a, s_lut, tid, S::kTileThreads);
  const Start st = start_regs(a);
  if (tid == 0) {
    s_count = 0u;
    // the tile by ticket, never by blockIdx: a CTA waits only on tiles
    // that CTAs already running hold
    s_tile = static_cast<int>(atomicAdd(counters, 1u));
  }
  __syncthreads();
  const int tile = s_tile;
  const int g0 = tile * S::kTileLanes + tid * kL;
  const int n_mine = clampi(a.n - g0, 0, kL);
  Lanes<kL> L;
  load_all<kDraw, kL>(a, g0, n_mine, L);
  cp_async_wait_all();
  __syncthreads();                               // the LUT

  const uint32_t sel = select_lanes<kL>(a, s_lut, L, n_mine);
  const uint32_t mine =
      static_cast<uint32_t>(__popc(sel)) * static_cast<uint32_t>(a.cost_us);
  uint32_t total;
  uint32_t spend = block_scan(mine, s_warp, lane, warp,
                              S::kTileThreads / 32, total);
  if (warp == 0) {
    const uint32_t carry =
        look_back(a.scratch + kCounterWords, tile, total, lane);
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  spend += s_carry;

  int credit_last = 0;
  const uint32_t got = grant_lanes<kL>(a, L, sel, spend, st, g0, n_mine,
                                       credit_last);
  const uint32_t warp_count =
      __reduce_add_sync(kFull, static_cast<uint32_t>(__popc(got)));
  if (lane == 0 && warp_count) atomicAdd(&s_count, warp_count);
  __syncthreads();                               // the tile's count
  if (tid == 0) {
    atomicAdd(counters + 2, s_count);
    __threadfence();
    if (atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
      // the last tile to finish: every other count is in
      __threadfence();
      const uint32_t granted = atomicAdd(counters + 2, 0u);
      a.bucket_out[0] = bucket_level(credit_at(a.ts[a.n - 1], st), granted, a);
    }
  }
}

template <bool kDraw>
int scratch_words(int n) {
  using S = Shape<kDraw>;
  return n > S::kClusterLanes ? kCounterWords + (n - 1) / S::kTileLanes + 1
                              : 0;
}

template <bool kDraw>
int launch(Args a, int pipes, int scratch_size, cudaStream_t s) {
  using S = Shape<kDraw>;
  if (a.n < 1 || pipes < 1 || pipes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(int32_t)) * a.tb * a.cb;
  cudaError_t e = cudaSuccess;
  const int words = scratch_words<kDraw>(a.n);
  a.scratch_words = words;
  if (words > 0) {
    if (a.scratch == nullptr ||
        static_cast<long long>(scratch_size) <
            static_cast<long long>(words) * pipes)
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaMemsetAsync(a.scratch, 0,
                        sizeof(unsigned long long) * words * pipes, s);
    if (e == cudaSuccess && smem > 32 * 1024)
      e = cudaFuncSetAttribute(fused_gate_lookback_kernel<kDraw>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_gate_lookback_kernel<kDraw>
        <<<dim3(words - kCounterWords, pipes), S::kTileThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // one CTA alone up to kCtaThreads threads; above, up to kClusterMax
  // CTAs of at least kCtaMinLanes lanes each, the last one non-empty
  int ranks = a.n <= S::kCtaThreads * S::kLanes
                  ? 1
                  : (a.n - 1) / S::kCtaMinLanes + 1;
  if (ranks > S::kClusterMax) ranks = S::kClusterMax;
  const int lanes = (a.n - 1) / ranks + 1;
  const int threads = ((lanes - 1) / (S::kLanes * 32) + 1) * 32;
  ranks = (a.n - 1) / (threads * S::kLanes) + 1;
  if (smem > 32 * 1024)
    e = cudaFuncSetAttribute(fused_gate_cluster_kernel<kDraw>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, pipes);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;   // a cluster launch costs more
  e = cudaLaunchKernelEx(&cfg, fused_gate_cluster_kernel<kDraw>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

Args make_args(const void* t_i, const void* c_i, const void* ts,
               const void* rand16, const void* key, const void* lut,
               const void* bucket, const void* t_last, void* granted,
               void* bucket_out, void* scratch, int n, int tb, int cb,
               int t_shift, int c_shift, uint32_t rand_mask, int cost_us,
               int bucket_cap_us) {
  return {static_cast<const int32_t*>(t_i),
          static_cast<const int32_t*>(c_i),
          static_cast<const int32_t*>(ts),
          static_cast<const int32_t*>(rand16),
          static_cast<const int64_t*>(key),
          static_cast<const int32_t*>(lut),
          static_cast<const int32_t*>(bucket),
          static_cast<const int32_t*>(t_last),
          static_cast<uint8_t*>(granted),
          static_cast<int32_t*>(bucket_out),
          static_cast<unsigned long long*>(scratch), 0,
          n, tb, cb, t_shift, c_shift, rand_mask, cost_us, bucket_cap_us};
}

}  // namespace

// The int64 words of scratch that a batch of n lanes needs (draw != 0: the
// drawing variant): 0 for a batch of one cluster, else the counters and
// one status word a tile.  P pipes' batches need P times as many.
extern "C" int fused_gate_scratch_words(int n, int draw) {
  return draw ? scratch_words<true>(n) : scratch_words<false>(n);
}

// Rand-input variant, `pipes` batches of n lanes each: t_i, c_i, ts,
// rand16 and granted [pipes, n]; lut [pipes, tb, cb]; bucket and t_last,
// the batch-start registers, and bucket_out [pipes] int32, on the device.
// scratch holds scratch_size int64 words, at least pipes x
// fused_gate_scratch_words(n, 0) (null when that is 0).  Launches on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int fused_gate_launch(const void* t_i, const void* c_i,
                                 const void* ts, const void* rand16,
                                 const void* lut, const void* bucket,
                                 const void* t_last, void* granted,
                                 void* bucket_out, void* scratch,
                                 int scratch_size, int pipes, int n, int tb,
                                 int cb, int t_shift, int c_shift,
                                 int cost_us, int bucket_cap_us,
                                 void* stream) {
  return launch<false>(
      make_args(t_i, c_i, ts, rand16, nullptr, lut, bucket, t_last, granted,
                bucket_out, scratch, n, tb, cb, t_shift, c_shift, 0u,
                cost_us, bucket_cap_us),
      pipes, scratch_size, static_cast<cudaStream_t>(stream));
}

// Drawing variant: `key` holds each pipe's threefry subkey, [pipes, 2]
// int64 words of uint32 values, read on the device.  prob_bits in
// [1, 31]; scratch as above, pipes x fused_gate_scratch_words(n, 1).
extern "C" int fused_gate_prng_launch(const void* t_i, const void* c_i,
                                      const void* ts, const void* key,
                                      const void* lut, const void* bucket,
                                      const void* t_last, void* granted,
                                      void* bucket_out, void* scratch,
                                      int scratch_size, int pipes, int n,
                                      int tb, int cb, int t_shift,
                                      int c_shift, int prob_bits,
                                      int cost_us, int bucket_cap_us,
                                      void* stream) {
  return launch<true>(
      make_args(t_i, c_i, ts, nullptr, key, lut, bucket, t_last, granted,
                bucket_out, scratch, n, tb, cb, t_shift, c_shift,
                (1u << prob_bits) - 1u, cost_us, bucket_cap_us),
      pipes, scratch_size, static_cast<cudaStream_t>(stream));
}
