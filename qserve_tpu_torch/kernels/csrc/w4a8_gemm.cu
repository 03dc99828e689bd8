// W4A8 per-channel GEMM for Hopper (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_chn_pallas
// (and its large-M variant w4a8_gemm_per_chn_bigm_pallas: one kernel here
// serves every M from a decode batch to a packed prefill stream).
//
// Computes out[m, n] = bf16((psum * s1[n]) * a_scale[m] - sz[n] * a_sum[m])
// with psum = sum_k A[m, k] * Wq[k, n] in int32, where A is int8 [M, K] and
// Wq holds UINT4 values packed as int8 [K/2, N] with the JAX package's global
// half-split: packed row r carries Wq[r, :] in its low nibble and
// Wq[r + K/2, :] in its high nibble. The epilogue keeps that operation order
// with round-to-nearest intrinsics (no FMA contraction), so the output equals
// the plain PyTorch version bit for bit.
//
// What bounds it on an H100: at decode (M <= 64) the packed weights, K*N/2
// bytes per call, streamed once from HBM (3.35 TB/s); at prefill
// (M = 2048..4096) the int8 tensor-core rate (1979 TOP/s dense).
//
// Design: a shared-memory tiled int8 GEMM on mma.sync m16n8k32 (s8 x s8 ->
// s32). A block owns a 64x64 output tile and walks K in steps of 32 packed
// rows (64 logical k): it stages the two matching 32-column slices of A and
// the packed weight rows, unpacks the nibbles once into shared memory as
// [n][k] bytes (so each B fragment is one 32-bit load), and four warps each
// run a 32x32 sub-tile. The nibble unpack happens on the fly, so the weights
// cross HBM at 4 bits. No cp.async/TMA pipeline and no wgmma yet: this is
// the simple correct version; a later change makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BKP = 32;      // packed weight rows per k step (64 logical k)
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

__global__ void __launch_bounds__(THREADS)
w4a8_gemm_per_chn_kernel(const int8_t* __restrict__ A,
                         const int8_t* __restrict__ W,
                         const float* __restrict__ s1,
                         const float* __restrict__ sz,
                         const float* __restrict__ a_scale,
                         const float* __restrict__ a_sum,
                         __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int K2 = K / 2;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int r0 = 0; r0 < K2; r0 += BKP) {
    // A tile: bytes [0, 32) of a row are A[m, r0 : r0+32) (low-nibble
    // partners), bytes [32, 64) are A[m, K/2+r0 : K/2+r0+32).
    for (int i = tid; i < BM * 4; i += THREADS) {
      const int row = i >> 2, part = i & 3;
      const int col = (part < 2) ? (r0 + part * 16) : (K2 + r0 + (part - 2) * 16);
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < M)
        v = *reinterpret_cast<const int4*>(A + (size_t)(m0 + row) * K + col);
      *reinterpret_cast<int4*>(As + row * LDS + part * 16) = v;
    }
    // W tile: 32 packed rows x 64 columns, one 16-byte load per thread,
    // unpacked to Bs[n][k] with k in [0, 32) low and [32, 64) high nibbles.
    {
      const int r = tid >> 2, nq = (tid & 3) * 16;
      const int4 v =
          *reinterpret_cast<const int4*>(W + (size_t)(r0 + r) * N + n0 + nq);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        Bs[(nq + j) * LDS + r] = (int8_t)(b[j] & 0xF);
        Bs[(nq + j) * LDS + 32 + r] = (int8_t)(b[j] >> 4);
      }
    }
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

  // Epilogue: (psum * s1) * a_scale - sz * a_sum, rounded once to bf16.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= M) continue;
      const float as = a_scale[row], asum = a_sum[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + t * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = __int2float_rn(acc[mi][ni][half * 2 + e]);
          v[e] = __fsub_rn(__fmul_rn(__fmul_rn(p, s1[col + e]), as),
                           __fmul_rn(sz[col + e], asum));
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

}  // namespace

// A [M, K] int8, W [K/2, N] int8, s1/sz [N] f32, a_scale/a_sum [M] f32,
// out [M, N] bf16; K % 64 == 0 and N % 64 == 0 (checked by the wrapper).
extern "C" int qs_w4a8_gemm_per_chn(const void* A, const void* W,
                                    const void* s1, const void* sz,
                                    const void* a_scale, const void* a_sum,
                                    void* out, int M, int N, int K,
                                    void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  w4a8_gemm_per_chn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)W, (const float*)s1, (const float*)sz,
      (const float*)a_scale, (const float*)a_sum, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}
