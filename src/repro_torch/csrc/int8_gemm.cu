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
// K is small (96..512), so each output tile sees few k-steps and the tile
// loads and the epilogue weigh more than in a large GEMM.
//
// Design: 64x64 output tiles, one CTA of four warps, each warp a 32x32
// sub-tile built from mma.sync.m16n8k32 s8.s8.s32 tensor-core steps.  A
// and B stage through shared memory 32 k-columns at a time; B is stored
// transposed so both operands' fragments are single 32-bit loads.  Edges
// are masked at load (zero fill) and at store, so the caller pads
// nothing, unlike the TPU kernel's 128-multiple blocks.  wgmma, TMA and
// a multi-stage pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 16;   // smem row stride in bytes: no bank conflicts
constexpr int kThreads = 128;

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

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 const int32_t* __restrict__ bias, int8_t* __restrict__ out8,
                 int32_t* __restrict__ out32, int M, int N, int K,
                 int shift) {
  __shared__ __align__(16) int8_t sA[BM][LDS];   // sA[m][k]
  __shared__ __align__(16) int8_t sB[BN][LDS];   // sB[n][k] (B transposed)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;      // mma groupID
  const int t = lane & 3;       // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      sA[r][c] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      sB[c][r] = (gk < K && gn < N) ? B[static_cast<size_t>(gk) * N + gn] : 0;
    }
    __syncthreads();
    uint32_t af[2][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(&sA[r][t * 4]);
      af[i][1] = *reinterpret_cast<const uint32_t*>(&sA[r + 8][t * 4]);
      af[i][2] = *reinterpret_cast<const uint32_t*>(&sA[r][16 + t * 4]);
      af[i][3] = *reinterpret_cast<const uint32_t*>(&sA[r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(&sB[c][t * 4]);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(&sB[c][16 + t * 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  const int half = shift > 0 ? (1 << (shift - 1)) : 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // accumulator fragment: rows g / g+8, columns 2t / 2t+1
        const int gm = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int gn = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (gm >= M || gn >= N) continue;
        int v = acc[i][j][r];
        if (bias != nullptr) v = wrap_add(v, bias[gn]);
        const size_t o = static_cast<size_t>(gm) * N + gn;
        if (shift < 0) {
          out32[o] = v;
        } else {
          if (shift > 0) v = wrap_add(v, half) >> shift;
          out8[o] = static_cast<int8_t>(v < -127 ? -127 : (v > 127 ? 127 : v));
        }
      }
    }
  }
}

}  // namespace

// shift < 0 selects the raw int32 output (`out` is int32[M,N]); otherwise
// `out` is int8[M,N].  `bias` may be null.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int int8_gemm_launch(const void* a, const void* b,
                                const void* bias, void* out, int M, int N,
                                int K, int shift, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(bias),
      shift < 0 ? nullptr : static_cast<int8_t*>(out),
      shift < 0 ? static_cast<int32_t*>(out) : nullptr, M, N, K, shift);
  return static_cast<int>(cudaGetLastError());
}
