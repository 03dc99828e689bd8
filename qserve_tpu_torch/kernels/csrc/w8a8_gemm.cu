// W8A8 GEMM for Hopper (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w8a8_gemm_pallas and, as a
// second entry point, w8a8_gemm_routed_pallas (the MoE routed dispatch).
//
// Computes out[m, n] = (psum * w_scale[n]) * a_scale[m] in bf16 or f32 (the
// W8 lm_head writes f32 logits), with psum = sum_k A[m, k] * W[k, n] in
// int32, A int8 [M, K], W int8 [K, N]. The epilogue rounds each product to
// nearest (no FMA contraction), so the output equals the plain PyTorch
// version bit for bit.
//
// What bounds it on an H100: at decode (M <= 64) the weights, K*N bytes per
// call, streamed once from HBM (3.35 TB/s); at prefill (M = 2048..4096) the
// int8 tensor-core rate (1979 TOP/s dense).
//
// Design: the main loop of gemm_common.cuh with a B stager that transposes a
// [64 k][64 n] int8 tile of W into shared memory as [n][k] bytes, two
// 16-byte loads per thread.

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

struct StageW8 {
  const int8_t* __restrict__ W;
  int N;
  __device__ __forceinline__ void operator()(int step, int8_t* Bs) const {
    for (int i = threadIdx.x; i < 64 * 4; i += THREADS) {
      const int r = i >> 2, nq = (i & 3) * 16;
      const int4 v =
          ld16(W + (size_t)(step * 64 + r) * N + blockIdx.x * BN + nq);
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(nq + j) * LDS + r] = b[j];
    }
  }
};

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w8a8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ a_scale, OutT* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  StageW8 stage{W, N};
  const ScaleEpilogue<OutT> epilogue{w_scale, a_scale, out, N};
  gemm_s8_block(A, M, K, K / 64, 64, 32, As, Bs, stage, epilogue);
}

// The routed (grouped) form for the MoE prefill dispatch, as in
// w4a8_gemm.cu: a 64-row block reads its expert from block_expert, offsets
// W ([NE, K, N]) and w_scale ([NE, N]) by that expert's stride in size_t
// (eight experts of Mixtral's W8 gate_up hold 939 MB), and runs the dense
// loop unchanged. Pad rows (q = 0, scale 0) come out exactly 0.
__global__ void __launch_bounds__(THREADS)
w8a8_gemm_routed_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ W,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ a_scale,
                        const int* __restrict__ block_expert,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K,
                        int route_rows) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const size_t e = (size_t)block_expert[(blockIdx.y * BM) / route_rows];
  StageW8 stage{W + e * (size_t)K * N, N};
  const ScaleEpilogue<__nv_bfloat16> epilogue{w_scale + e * N, a_scale, out,
                                              N};
  gemm_s8_block(A, M, K, K / 64, 64, 32, As, Bs, stage, epilogue);
}

}  // namespace

// A [M, K] int8, W [K, N] int8, w_scale [N] f32, a_scale [M] f32, out
// [M, N] bf16 (out_f32 == 0) or f32; K % 64 == 0 and N % 64 == 0 (checked by
// the wrapper).
extern "C" int qs_w8a8_gemm(const void* A, const void* W, const void* w_scale,
                            const void* a_scale, void* out, int out_f32,
                            int M, int N, int K, void* stream) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_f32)
    w8a8_gemm_kernel<float><<<grid, THREADS, 0, st>>>(
        (const int8_t*)A, (const int8_t*)W, (const float*)w_scale,
        (const float*)a_scale, (float*)out, M, N, K);
  else
    w8a8_gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const int8_t*)A, (const int8_t*)W, (const float*)w_scale,
        (const float*)a_scale, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}

// The routed form: W [NE, K, N] int8, w_scale [NE, N] f32, block_expert
// [M / route_rows] int32 in [0, NE), out [M, N] bf16; route_rows % 64 == 0
// and M % route_rows == 0, the rest as above (checked by the wrapper).
extern "C" int qs_w8a8_gemm_routed(const void* A, const void* W,
                                   const void* w_scale, const void* a_scale,
                                   const void* block_expert, void* out, int M,
                                   int N, int K, int route_rows,
                                   void* stream) {
  const dim3 grid(N / BN, M / BM);
  w8a8_gemm_routed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)W, (const float*)w_scale,
      (const float*)a_scale, (const int*)block_expert, (__nv_bfloat16*)out, M,
      N, K, route_rows);
  return (int)cudaGetLastError();
}
