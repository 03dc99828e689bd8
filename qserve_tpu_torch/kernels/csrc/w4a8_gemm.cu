// W4A8 per-channel GEMM for Hopper (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_chn_pallas
// (and its large-M variant w4a8_gemm_per_chn_bigm_pallas: one kernel here
// serves every M from a decode batch to a packed prefill stream), and, as a
// second entry point, w4a8_gemm_per_chn_routed_pallas (the MoE routed
// dispatch: see the routed entry point below).
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
// Design: the wgmma main loop of gemm_common.cuh (its first user, at every
// M: at M = 8 and 64 it measured 2-2.4x faster than the earlier 64x64
// mma.sync loop, whose tiles it wastes half of: scripts/ab_decode_gemm.py),
// with the nibble unpack as its B stage: a step's 32 packed rows arrive by
// cp.async beside A's two 32-column runs (at s*32 and K/2 + s*32), and all
// 256 threads transpose 4x4 byte blocks and split the nibbles with
// 0x0F0F0F0F masks (low plane -> k 0..31, high -> k 32..63). The weights
// cross HBM at 4 bits. The routed form runs the same loop: its blocks are
// whole 128-row tiles (the engine routes in 256-row blocks), and each block
// reads its expert.

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

// (psum * s1) * a_scale - sz * a_sum, rounded once to bf16.
struct PerChnEpilogue {
  using Out = __nv_bfloat16;
  struct Row {
    float as, asum;
  };
  const float* __restrict__ s1;
  const float* __restrict__ sz;
  const float* __restrict__ a_scale;
  const float* __restrict__ a_sum;
  Out* __restrict__ out;
  __device__ __forceinline__ Row row(int r) const { return {a_scale[r], a_sum[r]}; }
  __device__ __forceinline__ float one(int p, int col, Row r) const {
    return __fsub_rn(__fmul_rn(__fmul_rn(__int2float_rn(p), s1[col]), r.as),
                     __fmul_rn(sz[col], r.asum));
  }
};

// The B stage: a step's 32 packed rows x 128 columns (4 KB) by cp.async,
// one 16-byte granule a thread; each thread transposes one 4x4 block and
// splits its nibbles (low plane -> k 0..31, high -> k 32..63).
struct StageW4 {
  static constexpr int kSlot = 32 * WG_WROW;
  const int8_t* __restrict__ W;  // [K/2, N] packed nibbles
  int N, n0;
  Quad t;
  __device__ __forceinline__ StageW4(const int8_t* W, int N)
      : W(W), N(N), n0(blockIdx.y * WG_BN) {}
  __device__ __forceinline__ void issue(int s, unsigned char* slot) const {
    const int wr = threadIdx.x >> 3, wc = (threadIdx.x & 7) * 16;
    const bool ok = n0 + wc < N;
    cp_async16(slot + wr * WG_WROW + wc,
               W + (size_t)(s * 32 + wr) * N + (ok ? n0 + wc : 0), ok);
  }
  __device__ __forceinline__ void convert(int, const unsigned char* slot,
                                          unsigned char* bs) const {
    uint32_t col[4];
    t.transpose(slot, col);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = t.offset(jj);
      *reinterpret_cast<uint32_t*>(bs + o) = col[jj] & 0x0F0F0F0Fu;            // k < 32
      *reinterpret_cast<uint32_t*>(bs + o + 256) = (col[jj] >> 4) & 0x0F0F0F0Fu;  // k + 32
    }
  }
};

__global__ void __launch_bounds__(WG_THREADS)
w4a8_gemm_per_chn_wgmma_kernel(const int8_t* __restrict__ A,
                               const int8_t* __restrict__ W,
                               const float* __restrict__ s1,
                               const float* __restrict__ sz,
                               const float* __restrict__ a_scale,
                               const float* __restrict__ a_sum,
                               const int* __restrict__ block_expert,
                               __nv_bfloat16* __restrict__ out, int M, int N,
                               int K, int route_rows) {
  // routed: the block's expert (route_rows % 128 == 0, checked by the
  // wrapper), pointers offset in size_t
  const size_t e =
      block_expert ? (size_t)block_expert[(blockIdx.x * WG_BM) / route_rows] : 0;
  const PerChnEpilogue epilogue{s1 + e * N, sz + e * N, a_scale, a_sum, out};
  StageW4 stage(W + e * (size_t)(K / 2) * N, N);
  wgmma_gemm_tile(A, stage, epilogue, M, N, K, 32, K / 2);
}

constexpr int SMEM = wgmma_smem<StageW4, PerChnEpilogue>();

int launch(const void* A, const void* W, const void* s1, const void* sz,
           const void* a_scale, const void* a_sum, const void* block_expert,
           void* out, int M, int N, int K, int route_rows, cudaStream_t st) {
  return launch_tiles<w4a8_gemm_per_chn_wgmma_kernel>(
      SMEM, M, N, st, (const int8_t*)A, (const int8_t*)W, (const float*)s1,
      (const float*)sz, (const float*)a_scale, (const float*)a_sum,
      (const int*)block_expert, (__nv_bfloat16*)out, M, N, K, route_rows);
}

}  // namespace

// A [M, K] int8, W [K/2, N] int8, s1/sz [N] f32, a_scale/a_sum [M] f32,
// out [M, N] bf16; K % 64 == 0 and N % 64 == 0 (checked by the wrapper).
extern "C" int qs_w4a8_gemm_per_chn(const void* A, const void* W,
                                    const void* s1, const void* sz,
                                    const void* a_scale, const void* a_sum,
                                    void* out, int M, int N, int K,
                                    void* stream) {
  return launch(A, W, s1, sz, a_scale, a_sum, nullptr, out, M, N, K, M,
                      (cudaStream_t)stream);
}

// The routed (grouped) form for the MoE prefill dispatch: A is a stream of
// tokens sorted by expert and padded so that each route_rows-row block
// belongs to one expert; W [NE, K/2, N] int8, s1/sz [NE, N] f32,
// block_expert [M / route_rows] int32 in [0, NE) (the TPU kernel had it by
// scalar prefetch); route_rows % 128 == 0 and M % route_rows == 0 (checked
// by the wrapper), the rest as above. Pad rows carry q = 0, scale 0 and
// sum 0 and come out exactly 0; the all-pad tail blocks name the last
// expert and compute zeros too.
extern "C" int qs_w4a8_gemm_per_chn_routed(const void* A, const void* W,
                                           const void* s1, const void* sz,
                                           const void* a_scale,
                                           const void* a_sum,
                                           const void* block_expert, void* out,
                                           int M, int N, int K, int route_rows,
                                           void* stream) {
  return launch(A, W, s1, sz, a_scale, a_sum, block_expert, out, M, N, K,
                      route_rows, (cudaStream_t)stream);
}
