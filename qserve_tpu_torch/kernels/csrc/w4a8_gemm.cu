// W4A8 per-channel GEMM for Hopper (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_chn_pallas
// (and its large-M variant w4a8_gemm_per_chn_bigm_pallas: one kernel here
// serves every M from a decode batch to a packed prefill stream), and, as a
// second entry point, w4a8_gemm_per_chn_routed_pallas (the MoE routed
// dispatch: see the routed kernel below).
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
// Design: the shared-memory tiled int8 GEMM of gemm_common.cuh on mma.sync
// m16n8k32 (s8 x s8 -> s32). A block owns a 64x64 output tile and walks K
// in steps of 32 packed rows (64 logical k): it stages the two matching
// 32-column slices of A and the packed weight rows, unpacks the nibbles once
// into shared memory as [n][k] bytes (so each B fragment is one 32-bit
// load), and four warps each run a 32x32 sub-tile. The nibble unpack happens
// on the fly, so the weights cross HBM at 4 bits. No cp.async/TMA pipeline
// and no wgmma yet: this is the simple correct version; a later change makes
// it fast.

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

// 32 packed rows x 64 columns, one 16-byte load per thread, unpacked to
// Bs[n][k] with k in [0, 32) the low and [32, 64) the high nibbles.
struct StageW4 {
  const int8_t* __restrict__ W;
  int N;
  __device__ __forceinline__ void operator()(int step, int8_t* Bs) const {
    const int r = threadIdx.x >> 2, nq = (threadIdx.x & 3) * 16;
    const int4 v =
        ld16(W + (size_t)(step * 32 + r) * N + blockIdx.x * BN + nq);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      Bs[(nq + j) * LDS + r] = (int8_t)(b[j] & 0xF);
      Bs[(nq + j) * LDS + 32 + r] = (int8_t)(b[j] >> 4);
    }
  }
};

// (psum * s1) * a_scale - sz * a_sum, rounded once to bf16.
struct PerChnEpilogue {
  const float* __restrict__ s1;
  const float* __restrict__ sz;
  const float* __restrict__ a_scale;
  const float* __restrict__ a_sum;
  __nv_bfloat16* __restrict__ out;
  int N;
  __device__ __forceinline__ float one(int p, int col, float as,
                                       float asum) const {
    return __fsub_rn(__fmul_rn(__fmul_rn(__int2float_rn(p), s1[col]), as),
                     __fmul_rn(sz[col], asum));
  }
  __device__ __forceinline__ void operator()(int row, int col, int p0,
                                             int p1) const {
    const float as = a_scale[row], asum = a_sum[row];
    store2(out, (size_t)row * N + col, one(p0, col, as, asum),
           one(p1, col + 1, as, asum));
  }
};

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
  StageW4 stage{W, N};
  const PerChnEpilogue epilogue{s1, sz, a_scale, a_sum, out, N};
  gemm_s8_block(A, M, K, K / 64, 32, K / 2, As, Bs, stage, epilogue);
}

// The routed (grouped) form for the MoE prefill dispatch. A is a stream of
// tokens sorted by expert and padded so that each route_rows-row block
// belongs to one expert; W, s1 and sz hold every expert ([NE, K/2, N],
// [NE, N]). A 64-row block reads its expert from block_expert (the TPU
// kernel had it by scalar prefetch), offsets the weight and scale pointers
// by that expert's stride, in size_t as every offset of the main loop, and
// runs the dense loop unchanged. Pad rows carry q = 0, scale 0 and sum 0 and
// come out exactly 0; the all-pad tail blocks name the last expert and
// compute zeros too.
__global__ void __launch_bounds__(THREADS)
w4a8_gemm_per_chn_routed_kernel(const int8_t* __restrict__ A,
                                const int8_t* __restrict__ W,
                                const float* __restrict__ s1,
                                const float* __restrict__ sz,
                                const float* __restrict__ a_scale,
                                const float* __restrict__ a_sum,
                                const int* __restrict__ block_expert,
                                __nv_bfloat16* __restrict__ out, int M, int N,
                                int K, int route_rows) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const size_t e = (size_t)block_expert[(blockIdx.y * BM) / route_rows];
  StageW4 stage{W + e * (size_t)(K / 2) * N, N};
  const PerChnEpilogue epilogue{s1 + e * N, sz + e * N, a_scale, a_sum, out,
                                N};
  gemm_s8_block(A, M, K, K / 64, 32, K / 2, As, Bs, stage, epilogue);
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

// The routed form: W [NE, K/2, N] int8, s1/sz [NE, N] f32, block_expert
// [M / route_rows] int32 in [0, NE); route_rows % 64 == 0 and
// M % route_rows == 0 (checked by the wrapper), the rest as above.
extern "C" int qs_w4a8_gemm_per_chn_routed(const void* A, const void* W,
                                           const void* s1, const void* sz,
                                           const void* a_scale,
                                           const void* a_sum,
                                           const void* block_expert, void* out,
                                           int M, int N, int K, int route_rows,
                                           void* stream) {
  const dim3 grid(N / BN, M / BM);
  w4a8_gemm_per_chn_routed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)W, (const float*)s1, (const float*)sz,
      (const float*)a_scale, (const float*)a_sum, (const int*)block_expert,
      (__nv_bfloat16*)out, M, N, K, route_rows);
  return (int)cudaGetLastError();
}
