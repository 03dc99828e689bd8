// The int8 tensor-core main loops of the quantized GEMM kernels
// (w4a8_gemm.cu, w4a8_gemm_per_group.cu, w8a8_gemm.cu): gemm_s8_block
// (mma.sync: K8 and K9) and, below it, the wgmma pieces of K2's loop.
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

#include "cp_async.cuh"

namespace qs_gemm {

using namespace qs_async;

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

// ---------------------------------------------------------------------------
// Hopper pieces of the wgmma main loop (w4a8_gemm.cu's K2; K8 and K9 still
// run gemm_s8_block above). A warpgroup (4 warps) issues
// wgmma.mma_async m64n128k32 (s8 x s8 -> s32) with both operands in shared
// memory, K-major, in the canonical no-swizzle layout: 8 rows x 16 bytes
// form one 128-byte core matrix; the two core matrices of a 32-byte k slice
// lie LBO = 128 bytes apart and successive 8-row groups SBO bytes apart.
// ---------------------------------------------------------------------------

// a wgmma shared-memory matrix descriptor: no swizzle, base offset 0
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo,
                                               int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// this thread's shared-memory writes (st.shared, and cp.async data it has
// waited for) made visible to the tensor cores' async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d[64] += A[64 x 32] . B[32 x 128]^T, s8 x s8 -> s32; thread (warp w of the
// warpgroup, lane 4g + q) holds d[4j + e] of row 16w + g + 8 (e >> 1),
// column 8j + 2q + (e & 1)
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

}  // namespace qs_gemm
