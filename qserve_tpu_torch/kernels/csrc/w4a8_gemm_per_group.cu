// W4A8 per-group GEMM (two-level progressive dequantization) for Hopper
// (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_group_pallas and
// w4a8_gemm_per_group_whole_pallas. The TPU needed a second kernel for group
// counts that do not tile its sublanes (K = 11008: 43 groups a nibble
// plane); here one kernel serves every K with K % G == 0, groups that
// straddle the two nibble planes included (K/2 % G != 0: hidden 896 at
// g128). A second entry
// point replaces the routed MoE forms of both,
// w4a8_gemm_per_group_routed_pallas and
// w4a8_gemm_per_group_whole_routed_pallas (see the routed kernel below).
//
// Computes out[m, n] = (psum * s1[n]) * a_scale[m] in bf16 or f32, with
// psum = sum_k A[m, k] * W8[k, n] in int32 and
// W8[k, n] = int8(Wq[k, n] * s2[k / G, n] + z2[k / G, n]): Wq are UINT4
// values packed as int8 [K/2, N] with the JAX package's global half-split
// (packed row r carries Wq[r, :] in its low nibble and Wq[r + K/2, :] in
// its high nibble), s2 holds uint8 values in an int8 carrier and z2 int8,
// both [K/G, N]. The quantizer chooses s2 and z2 so that W8 fits an int8;
// off that lattice the value wraps, as the plain version's cast does. The
// level-2 reconstruction is integer arithmetic and the epilogue rounds each
// product to nearest (no FMA contraction), so the output equals the plain
// PyTorch version bit for bit.
//
// What bounds it on an H100: at decode (M <= 64) the packed weights and
// their group parameters, K*N/2 + 2*(K/G)*N bytes per call, streamed once
// from HBM (3.35 TB/s); at prefill (M = 2048..4096) the int8 tensor-core
// rate (1979 TOP/s dense).
//
// Design: the main loop of gemm_common.cuh. The two nibbles of a packed byte
// belong to different groups (rows r and r + K/2), so a thread keeps two
// 16-column rows of s2 and of z2 in registers, reloads each plane's when
// its 32 rows of k enter a new group (G % 32 == 0 and K % 64 == 0, so a
// step straddles none), and forms W8 = q * s2 + z2 as an int8 while it stages the tile:
// the tensor cores see plain int8 x int8, as QServe's own CUDA kernel does,
// and no float z-term is needed.

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

struct StageW4Group {
  const int8_t* __restrict__ W;   // [K/2, N] packed nibbles
  const int8_t* __restrict__ s2;  // [K/G, N] uint8 values
  const int8_t* __restrict__ z2;  // [K/G, N]
  int N, G, K2;                   // K2 = K/2, the high plane's first k
  // each plane's current group and the packed row r0 at which its next
  // group starts: the low plane's rows r0.. are k = r0.., the high
  // plane's k = K2 + r0.., so a group may straddle the planes (K2 % G != 0,
  // e.g. hidden 896 at g128); counters, not divisions, on the step path
  int lo_g, hi_g, lo_next, hi_next;
  int4 s2lo, s2hi, z2lo, z2hi;    // this thread's 16 columns, current groups

  __device__ __forceinline__ void operator()(int step, int8_t* Bs) {
    const int r = threadIdx.x >> 2, nq = (threadIdx.x & 3) * 16;
    const int r0 = step * 32;
    const size_t col = (size_t)blockIdx.x * BN + nq;
    if (r0 == lo_next) {
      const size_t lo = (size_t)lo_g * N + col;
      s2lo = ld16(s2 + lo);
      z2lo = ld16(z2 + lo);
      ++lo_g;
      lo_next += G;
    }
    if (r0 == hi_next) {
      const size_t hi = (size_t)hi_g * N + col;
      s2hi = ld16(s2 + hi);
      z2hi = ld16(z2 + hi);
      ++hi_g;
      hi_next = hi_g * G - K2;
    }
    const int4 v = ld16(W + (size_t)(r0 + r) * N + col);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
    const uint8_t* sl = reinterpret_cast<const uint8_t*>(&s2lo);
    const uint8_t* sh = reinterpret_cast<const uint8_t*>(&s2hi);
    const int8_t* zl = reinterpret_cast<const int8_t*>(&z2lo);
    const int8_t* zh = reinterpret_cast<const int8_t*>(&z2hi);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      Bs[(nq + j) * LDS + r] =
          (int8_t)((int)(b[j] & 0xF) * (int)sl[j] + (int)zl[j]);
      Bs[(nq + j) * LDS + 32 + r] =
          (int8_t)((int)(b[j] >> 4) * (int)sh[j] + (int)zh[j]);
    }
  }
};

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w4a8_gemm_per_group_kernel(const int8_t* __restrict__ A,
                           const int8_t* __restrict__ W,
                           const int8_t* __restrict__ s2,
                           const int8_t* __restrict__ z2,
                           const float* __restrict__ s1,
                           const float* __restrict__ a_scale,
                           OutT* __restrict__ out, int M, int N, int K,
                           int G) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int4 zero = make_int4(0, 0, 0, 0);
  StageW4Group stage{W, s2, z2, N, G, K / 2, 0, K / 2 / G, 0, 0,
                     zero, zero, zero, zero};
  const ScaleEpilogue<OutT> epilogue{s1, a_scale, out, N};
  gemm_s8_block(A, M, K, K / 64, 32, K / 2, As, Bs, stage, epilogue);
}

// The routed (grouped) form for the MoE prefill dispatch, as in
// w4a8_gemm.cu: a 64-row block reads its expert from block_expert, offsets
// W ([NE, K/2, N]), s2 and z2 ([NE, K/G, N]) and s1 ([NE, N]) by that
// expert's stride in size_t, and runs the dense loop unchanged. Pad rows
// (q = 0, scale 0) come out exactly 0.
__global__ void __launch_bounds__(THREADS)
w4a8_gemm_per_group_routed_kernel(const int8_t* __restrict__ A,
                                  const int8_t* __restrict__ W,
                                  const int8_t* __restrict__ s2,
                                  const int8_t* __restrict__ z2,
                                  const float* __restrict__ s1,
                                  const float* __restrict__ a_scale,
                                  const int* __restrict__ block_expert,
                                  __nv_bfloat16* __restrict__ out, int M,
                                  int N, int K, int G, int route_rows) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const size_t e = (size_t)block_expert[(blockIdx.y * BM) / route_rows];
  const size_t group_stride = (size_t)(K / G) * N;
  const int4 zero = make_int4(0, 0, 0, 0);
  StageW4Group stage{W + e * (size_t)(K / 2) * N, s2 + e * group_stride,
                     z2 + e * group_stride, N, G, K / 2, 0, K / 2 / G, 0, 0,
                     zero, zero, zero, zero};
  const ScaleEpilogue<__nv_bfloat16> epilogue{s1 + e * N, a_scale, out, N};
  gemm_s8_block(A, M, K, K / 64, 32, K / 2, As, Bs, stage, epilogue);
}

}  // namespace

// A [M, K] int8, W [K/2, N] int8, s2/z2 [K/G, N] int8, s1 [N] f32,
// a_scale [M] f32, out [M, N] bf16 (out_f32 == 0) or f32; K % 64 == 0,
// N % 64 == 0, G % 32 == 0 and K % G == 0 (checked by the wrapper).
extern "C" int qs_w4a8_gemm_per_group(const void* A, const void* W,
                                      const void* s2, const void* z2,
                                      const void* s1, const void* a_scale,
                                      void* out, int out_f32, int M, int N,
                                      int K, int G, void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_f32)
    w4a8_gemm_per_group_kernel<float><<<grid, THREADS, 0, st>>>(
        (const int8_t*)A, (const int8_t*)W, (const int8_t*)s2,
        (const int8_t*)z2, (const float*)s1, (const float*)a_scale,
        (float*)out, M, N, K, G);
  else
    w4a8_gemm_per_group_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const int8_t*)A, (const int8_t*)W, (const int8_t*)s2,
        (const int8_t*)z2, (const float*)s1, (const float*)a_scale,
        (__nv_bfloat16*)out, M, N, K, G);
  return (int)cudaGetLastError();
}

// The routed form: W [NE, K/2, N] int8, s2/z2 [NE, K/G, N] int8, s1 [NE, N]
// f32, block_expert [M / route_rows] int32 in [0, NE), out [M, N] bf16;
// route_rows % 64 == 0 and M % route_rows == 0, the rest as above (checked
// by the wrapper).
extern "C" int qs_w4a8_gemm_per_group_routed(const void* A, const void* W,
                                             const void* s2, const void* z2,
                                             const void* s1,
                                             const void* a_scale,
                                             const void* block_expert,
                                             void* out, int M, int N, int K,
                                             int G, int route_rows,
                                             void* stream) {
  const dim3 grid(N / BN, M / BM);
  w4a8_gemm_per_group_routed_kernel<<<grid, THREADS, 0,
                                      (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)W, (const int8_t*)s2,
      (const int8_t*)z2, (const float*)s1, (const float*)a_scale,
      (const int*)block_expert, (__nv_bfloat16*)out, M, N, K, G, route_rows);
  return (int)cudaGetLastError();
}
