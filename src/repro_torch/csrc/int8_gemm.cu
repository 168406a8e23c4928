// INT8 GEMM with int32 accumulation and a fused requantizing epilogue,
// the Model Engine's systolic array (FENIX §5.2).
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py ::
// int8_matmul_pallas (_kernel).  C = A[M,K](s8) . B[K,N](s8) in s32,
// plus an optional s32 bias.  With shift >= 0 the epilogue rounds half up,
// (acc + (1 << (shift-1))) >> shift, saturates to [-127, 127] and stores
// s8; with shift < 0 (no requantization) it stores the raw s32.
//
// Bound on the H100: bytes, at the serving shapes.  One chunk of the
// full-width CNN (1024 lanes x 9 steps) runs six GEMMs of about 1.46 GMAC
// over about 11.8 MB of operands and results, some 250 operations a byte
// against the card's 590 int8 operations per byte of memory bandwidth.
// K is small (96..512), so each output tile sees few k-steps: what counts
// is bytes in flight, enough CTAs on the SMs and coalesced stores, not the
// tensor-core rate.
//
// Design.  B is read K-major: column n of B is row n of a [N, ldb] buffer
// (the serving weights are packed so once, at load), which is the layout
// of mma.sync's .col B fragment, so both operands come in the same way.
// A [BM x 64] and a [BN x 64] tile of each k-step are copied with cp.async
// into a four-stage ring in shared memory (rows padded by 16 bytes, so the
// fragment reads hit distinct banks), with one block barrier a k-step;
// rows and k past the edges are zero-filled, so the caller pads nothing.
// The copies are 16 bytes when K, the leading dimensions and the pointers
// allow it, else 4 bytes, else single bytes (ragged K, as in the tiny
// model).  Each warp builds a WM x WN sub-tile from mma.sync.m16n8k32
// s8.s8.s32 steps on fragments read with ldmatrix.  The epilogue (bias
// with a wrapping add, the rounding shift, saturation) runs in registers;
// the tile then goes through shared memory so every output row is written
// with 16-byte stores, in int8 and in int32.
//
// Tile rule (kernel.py gemm_tile): the largest of six tiles (128x128 down
// to 32x8) that gives at least two CTAs per SM, skipping tiles at least
// twice as wide as N (and the 8-wide one unless N < 16); the smallest when
// none does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;          // k bytes a stage
constexpr int LDS = BK + 16;    // padded smem row (bytes)
constexpr int kStages = 4;      // a deeper ring measured slower (PERF.md)

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// four (x4) or two (x2) 8x16-byte matrices from shared memory; lane l
// gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one ALIGN-byte piece of a row; zeros when !ok (nothing is read then)
template <int ALIGN>
__device__ __forceinline__ void copy_piece(int8_t* dst, const int8_t* src,
                                           bool ok) {
  if constexpr (ALIGN == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (ALIGN == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  } else {
    *dst = ok ? *src : static_cast<int8_t>(0);
  }
}

// rows [r0, r0 + ROWS) x k [k0, k0 + BK) of a row-major [rows, ld] int8
// matrix into a [ROWS][LDS] smem tile; ALIGN divides K, so a piece is
// wholly inside K or wholly past it
template <int ROWS, int ALIGN, int THREADS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int64_t ld, int r0, int rows,
                                          int k0, int K) {
  constexpr int PER_ROW = BK / ALIGN;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * ALIGN;
    const bool ok = r0 + r < rows && k0 + c < K;
    copy_piece<ALIGN>(dst + r * LDS + c,
                      ok ? src + (r0 + r) * ld + k0 + c : src, ok);
  }
}

template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  static constexpr int kMi = WM / 16, kNi = WN / 8;
  static constexpr int kStage = (BM + BN) * LDS;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOut32 = BN + 4;    // int32 staging row (ints)
  static constexpr int kOut8 = BN + 16;    // int8 staging row (bytes)
  static constexpr int kSmem =
      kRing > BM * kOut32 * 4 ? kRing : BM * kOut32 * 4;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 &&
                WN % 8 == 0, "tile");
};

// the staged tile's rows to global memory, CH elements (16 bytes, or the
// whole row when it is shorter) a store where N allows, else one by one
template <typename T, int BM, int BN, int THREADS, int STRIDE>
__device__ __forceinline__ void store_tile(const T* stage, T* out, int m0,
                                           int n0, int M, int N) {
  constexpr int CH = 16 / sizeof(T) < BN ? 16 / sizeof(T) : BN;
  constexpr int PER_ROW = BN / CH;
  const bool vec = N % CH == 0;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CH;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const T* s = stage + r * STRIDE + c;
    T* o = out + static_cast<int64_t>(gm) * N + gn;
    if (vec && gn + CH <= N) {
      if constexpr (CH * sizeof(T) == 16) {
        *reinterpret_cast<int4*>(o) = *reinterpret_cast<const int4*>(s);
      } else if constexpr (CH * sizeof(T) == 8) {
        *reinterpret_cast<int2*>(o) = *reinterpret_cast<const int2*>(s);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) o[e] = s[e];
      }
    } else {
      for (int e = 0; e < CH && gn + e < N; ++e) o[e] = s[e];
    }
  }
}

template <int BM, int BN, int WM, int WN, int ALIGN>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN>::kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int32_t* __restrict__ bias, int8_t* __restrict__ out8,
                 int32_t* __restrict__ out32, int M, int N, int K,
                 int64_t lda, int64_t ldb, int shift) {
  using T = Tile<BM, BN, WM, WN>;
  constexpr int THREADS = T::kThreads, MI = T::kMi, NI = T::kNi;
  extern __shared__ __align__(16) int8_t smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;      // mma groupID
  const int t = lane & 3;       // mma threadID_in_group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load_stage = [&](int slot, int kt) {
    int8_t* sa = smem + slot * T::kStage;
    load_tile<BM, ALIGN, THREADS>(sa, A, lda, m0, M, kt * BK, K);
    load_tile<BN, ALIGN, THREADS>(sa + BM * LDS, B, ldb, n0, N, kt * BK, K);
  };

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    // stage kt is in for every thread, and every thread is done with the
    // slot the next copies overwrite (the one read at kt - 1)
    __syncthreads();
    if (kt + kStages - 1 < KT)
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const int8_t* sa = smem + (kt % kStages) * T::kStage;
    const int8_t* sb = sa + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      // ldmatrix: an 8x16-byte matrix gives each lane the 4 bytes of row
      // lane / 4 at k 4 * (lane % 4), the s8 fragment layout
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], sa + (wm + i * 16 + (lane & 7) +
                             8 * ((lane >> 3) & 1)) * LDS +
                           ks + 16 * (lane >> 4));
#pragma unroll
      for (int j = 0; j + 1 < NI; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, sb + (wn + 8 * (j + (lane >> 4)) + (lane & 7)) * LDS +
                       ks + 16 * ((lane >> 3) & 1));
        bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2],
        bf[j + 1][1] = r[3];
      }
      if constexpr (NI % 2 == 1)
        ldsm_x2(bf[NI - 1][0], bf[NI - 1][1],
                sb + (wn + 8 * (NI - 1) + (lane & 7)) * LDS + ks +
                    16 * ((lane >> 3) & 1));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the output tile

  // epilogue in registers, into the staging tile: accumulator fragment
  // rows g / g+8, columns 2t / 2t+1
  const int half = shift > 0 ? (1 << (shift - 1)) : 0;
  int32_t* st32 = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = wn + j * 8 + t * 2 + (r & 1);
        const int gn = n0 + col;
        int v = acc[i][j][r];
        if (bias != nullptr && gn < N) v = wrap_add(v, bias[gn]);
        if (shift < 0) {
          st32[row * T::kOut32 + col] = v;
        } else {
          if (shift > 0) v = wrap_add(v, half) >> shift;
          smem[row * T::kOut8 + col] =
              static_cast<int8_t>(v < -127 ? -127 : (v > 127 ? 127 : v));
        }
      }
    }
  }
  __syncthreads();
  if (shift < 0)
    store_tile<int32_t, BM, BN, THREADS, T::kOut32>(st32, out32, m0, n0, M,
                                                     N);
  else
    store_tile<int8_t, BM, BN, THREADS, T::kOut8>(smem, out8, m0, n0, M, N);
}

template <int BM, int BN, int WM, int WN, int ALIGN>
cudaError_t launch(const void* a, const void* b, const void* bias,
                   void* out, int M, int N, int K, int64_t lda,
                   int64_t ldb, int shift, cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN>;
  auto kernel = int8_gemm_kernel<BM, BN, WM, WN, ALIGN>;
  static bool configured = false;   // the attribute is set once a kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(bias),
      shift < 0 ? nullptr : static_cast<int8_t*>(out),
      shift < 0 ? static_cast<int32_t*>(out) : nullptr, M, N, K, lda, ldb,
      shift);
  return cudaGetLastError();
}

template <int ALIGN>
cudaError_t dispatch_tile(int tile, const void* a, const void* b,
                          const void* bias, void* out, int M, int N, int K,
                          int64_t lda, int64_t ldb, int shift,
                          cudaStream_t st) {
  switch (tile) {   // kernel.py TILES, in this order
    case 0:
      return launch<128, 128, 64, 32, ALIGN>(a, b, bias, out, M, N, K, lda,
                                             ldb, shift, st);
    case 1:
      return launch<128, 64, 32, 32, ALIGN>(a, b, bias, out, M, N, K, lda,
                                            ldb, shift, st);
    case 2:
      return launch<64, 64, 32, 32, ALIGN>(a, b, bias, out, M, N, K, lda,
                                           ldb, shift, st);
    case 3:
      return launch<64, 32, 32, 16, ALIGN>(a, b, bias, out, M, N, K, lda,
                                           ldb, shift, st);
    case 4:
      return launch<32, 32, 16, 16, ALIGN>(a, b, bias, out, M, N, K, lda,
                                           ldb, shift, st);
    case 5:
      return launch<32, 8, 16, 8, ALIGN>(a, b, bias, out, M, N, K, lda, ldb,
                                         shift, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// a [M, lda] row-major (K contiguous); b K-major: element (k, n) of B at
// b[n * ldb + k]; shift < 0 selects the raw int32 output (`out` is
// int32[M,N]), otherwise `out` is int8[M,N]; `bias` may be null.  `tile`
// picks the tile shape (kernel.py TILES); `align` (16, 4 or 1) is the copy
// width, which must divide K, lda, ldb and both operands' addresses.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int int8_gemm_launch(const void* a, const void* b,
                                const void* bias, void* out, int M, int N,
                                int K, long long lda, long long ldb,
                                int shift, int tile, int align,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (align) {
    case 16:
      return static_cast<int>(dispatch_tile<16>(tile, a, b, bias, out, M, N,
                                                K, lda, ldb, shift, st));
    case 4:
      return static_cast<int>(dispatch_tile<4>(tile, a, b, bias, out, M, N,
                                               K, lda, ldb, shift, st));
    case 1:
      return static_cast<int>(dispatch_tile<1>(tile, a, b, bias, out, M, N,
                                               K, lda, ldb, shift, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
