// The int8 tensor-core main loop shared by the quantized GEMM kernels
// (w4a8_gemm.cu, w4a8_gemm_per_group.cu, w8a8_gemm.cu).
//
// A block of 128 threads owns a 64x64 output tile and walks K in steps of 64
// logical k. Per step it stages a [64 m][64 k] int8 tile of A and a
// [64 n][64 k] int8 tile of B in shared memory and four warps each run a
// 32x32 sub-tile on mma.sync m16n8k32 (s8 x s8 -> s32). The kernels differ
// only in how the B tile is made (`StageB`: nibble unpack, per-group
// reconstruction, or a plain int8 transpose) and in the float epilogue
// (`Epilogue`); the integer sums are exact in every one of them.
//
// The 64 k of a step are two runs of 32 columns of A: run 0 starts at
// step * a_step, run 1 at step * a_step + a_hi. The W4 kernels pair the low
// nibble plane with columns [0, K/2) and the high plane with [K/2, K)
// (a_step = 32, a_hi = K/2); the W8 kernel takes 64 consecutive columns
// (a_step = 64, a_hi = 32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qs_gemm {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int LDS = 80;      // shared row stride in bytes: 64 data + 16 pad
constexpr int THREADS = 128; // 4 warps, 2 x 2 over the 64x64 tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int4 ld16(const void* p) {
  return *reinterpret_cast<const int4*>(p);
}

// two adjacent outputs of one row, rounded once to the output type
__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t i, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* out, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}

// Epilogue of the per-group W4 and the W8 kernels:
// out = (psum * w_scale[n]) * a_scale[m], each product rounded to nearest
// (no FMA contraction), so it equals the plain PyTorch version bit for bit.
template <typename OutT>
struct ScaleEpilogue {
  const float* __restrict__ w_scale;
  const float* __restrict__ a_scale;
  OutT* __restrict__ out;
  int N;
  __device__ __forceinline__ void operator()(int row, int col, int p0,
                                             int p1) const {
    const float as = a_scale[row];
    store2(out, (size_t)row * N + col,
           __fmul_rn(__fmul_rn(__int2float_rn(p0), w_scale[col]), as),
           __fmul_rn(__fmul_rn(__int2float_rn(p1), w_scale[col + 1]), as));
  }
};

// One block's 64x64 tile. As, Bs: shared int8 [64 * LDS] each.
// stage_b(step, Bs) writes Bs[n * LDS + k] for n, k in [0, 64);
// epilogue(row, col, psum(row, col), psum(row, col + 1)) stores two outputs.
template <class StageB, class Epilogue>
__device__ __forceinline__ void gemm_s8_block(const int8_t* __restrict__ A,
                                              int M, int K, int nsteps,
                                              int a_step, int a_hi,
                                              int8_t* As, int8_t* Bs,
                                              StageB& stage_b,
                                              const Epilogue& epilogue) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int step = 0; step < nsteps; ++step) {
    for (int i = tid; i < BM * 4; i += THREADS) {
      const int row = i >> 2, part = i & 3;
      const int col = step * a_step + (part >> 1) * a_hi + (part & 1) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < M) v = ld16(A + (size_t)(m0 + row) * K + col);
      *reinterpret_cast<int4*>(As + row * LDS + part * 16) = v;
    }
    stage_b(step, Bs);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < 64; kk += 32) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = As + (wm + mi * 16 + g) * LDS + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = Bs + (wn + ni * 8 + g) * LDS + kk + t * 4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        epilogue(row, n0 + wn + ni * 8 + t * 2, acc[mi][ni][half * 2],
                 acc[mi][ni][half * 2 + 1]);
    }
  }
}

}  // namespace qs_gemm
