// W8A8 GEMM for Hopper (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w8a8_gemm_pallas and, as a
// second entry point, w8a8_gemm_routed_pallas (the MoE routed dispatch).
//
// Computes out[m, n] = (psum * w_scale[n]) * a_scale[m] in bf16 or f32 (the
// W8 lm_head writes f32 logits), with psum = sum_k A[m, k] * W[k, n] in
// int32, A int8 [M, K], W int8 [K, N] (N-major: the JAX package's layout,
// kept as it is). The epilogue rounds each product to nearest (no FMA
// contraction), so the output equals the plain PyTorch version bit for bit.
//
// What bounds it on an H100: at decode (M <= 64) the weights, K*N bytes per
// call, streamed once from HBM (3.35 TB/s); at prefill (M = 2048..6144) the
// int8 tensor-core rate (1979 TOP/s dense).
//
// Design: the wgmma main loop of gemm_common.cuh with a transpose as its B
// stage. A step copies 64 rows x 128 columns of W (8 KB, twice K2's packed
// 4 KB) into the ring, two 16-byte granules a thread, beside one 64-column
// run of A; all 256 threads then transpose two 4x4 byte blocks each with
// __byte_perm (rows 4rq.. -> k 0..31, rows 32 + 4rq.. -> k 32..63) into the
// K-major tile, with K2's lane rotation so a warp's stores hit 32 banks.
// The weights cross HBM at 8 bits: twice K2's bytes at decode. A load-time
// repack of W to [N, K] would let the copy land K-major with no transpose
// (and by TMA); the layout is the shared one the JAX package writes, so
// that is left for later. The f32 output tile (128 x 136 x 4 = 69.6 KB)
// fits in the ring's 86 KB, so both outputs are staged the same way.
// The routed form runs the same loop: its blocks are whole 128-row tiles
// and each reads its expert's W and w_scale (eight experts of Mixtral's W8
// gate_up hold 939 MB: offsets in size_t).

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

// The B stage: 64 rows of W, transposed
struct StageW8 {
  static constexpr int kSlot = 64 * WG_WROW;
  const int8_t* __restrict__ W;  // [K, N]
  int N, n0;
  Quad t;
  __device__ __forceinline__ StageW8(const int8_t* W, int N)
      : W(W), N(N), n0(blockIdx.y * WG_BN) {}
  __device__ __forceinline__ void issue(int s, unsigned char* slot) const {
    const int wc = (threadIdx.x & 7) * 16;
    const bool ok = n0 + wc < N;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int wr = (threadIdx.x >> 3) + 32 * u;
      cp_async16(slot + wr * WG_WROW + wc,
                 W + (size_t)(s * 64 + wr) * N + (ok ? n0 + wc : 0), ok);
    }
  }
  __device__ __forceinline__ void convert(int, const unsigned char* slot,
                                          unsigned char* bs) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 32h.. -> k 32h..
      uint32_t col[4];
      t.transpose(slot + 32 * h * WG_WROW, col);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<uint32_t*>(bs + t.offset(jj) + 256 * h) = col[jj];
    }
  }
};

// One tile, over all of K or (kSplit) over the block's K slice; the routed
// form's block reads its expert (route_rows % 128 == 0, checked by the
// wrapper), pointers offset in size_t.
template <bool kSplit, typename OutT>
__device__ __forceinline__ void w8a8_tile(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W,
    const float* __restrict__ w_scale, const float* __restrict__ a_scale,
    const int* __restrict__ block_expert, OutT* __restrict__ out, int M, int N,
    int K, int route_rows, SplitK ws) {
  const size_t e =
      block_expert ? (size_t)block_expert[(blockIdx.x * WG_BM) / route_rows] : 0;
  const ScaleEpilogue<OutT> epilogue{w_scale + e * N, a_scale, out};
  StageW8 stage(W + e * (size_t)K * N, N);
  wgmma_gemm_tile<kSplit>(A, stage, epilogue, M, N, K, 64, 32, ws);
}

template <typename OutT>
__global__ void __launch_bounds__(WG_THREADS)
w8a8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ a_scale,
                 const int* __restrict__ block_expert, OutT* __restrict__ out,
                 int M, int N, int K, int route_rows) {
  w8a8_tile<false>(A, W, w_scale, a_scale, block_expert, out, M, N, K,
                   route_rows, SplitK{});
}

// the same with K split into gridDim.z slices (gemm_common.cuh)
template <typename OutT>
__global__ void __launch_bounds__(WG_THREADS)
w8a8_gemm_split_kernel(const int8_t* __restrict__ A,
                       const int8_t* __restrict__ W,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ a_scale,
                       const int* __restrict__ block_expert,
                       OutT* __restrict__ out, int M, int N, int K,
                       int route_rows, SplitK ws) {
  w8a8_tile<true>(A, W, w_scale, a_scale, block_expert, out, M, N, K,
                  route_rows, ws);
}

template <typename OutT>
int launch(const void* A, const void* W, const void* w_scale,
           const void* a_scale, const void* block_expert, void* out, int M,
           int N, int K, int route_rows, int splits, void* partials,
           void* arrivals, cudaStream_t st) {
  constexpr int smem = wgmma_smem<StageW8, ScaleEpilogue<OutT>>();
  const auto a = (const int8_t*)A, w = (const int8_t*)W;
  const auto wsc = (const float*)w_scale, as = (const float*)a_scale;
  const auto be = (const int*)block_expert;
  if (splits > 1)
    return launch_tiles<w8a8_gemm_split_kernel<OutT>>(
        smem, M, N, splits, st, a, w, wsc, as, be, (OutT*)out, M, N, K,
        route_rows, SplitK{(int4*)partials, (int*)arrivals});
  return launch_tiles<w8a8_gemm_kernel<OutT>>(smem, M, N, splits, st, a, w,
                                              wsc, as, be, (OutT*)out, M, N, K,
                                              route_rows);
}

}  // namespace

// A [M, K] int8, W [K, N] int8, w_scale [N] f32, a_scale [M] f32, out
// [M, N] bf16 (out_f32 == 0) or f32; K % 64 == 0 and N % 64 == 0 (checked by
// the wrapper); splits, partials, arrivals: K2's (w4a8_gemm.cu).
extern "C" int qs_w8a8_gemm(const void* A, const void* W, const void* w_scale,
                            const void* a_scale, void* out, int out_f32,
                            int M, int N, int K, int splits, void* partials,
                            void* arrivals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? launch<float>(A, W, w_scale, a_scale, nullptr, out, M, N,
                                 K, M, splits, partials, arrivals, st)
                 : launch<__nv_bfloat16>(A, W, w_scale, a_scale, nullptr, out,
                                         M, N, K, M, splits, partials,
                                         arrivals, st);
}

// The routed form: W [NE, K, N] int8, w_scale [NE, N] f32, block_expert
// [M / route_rows] int32 in [0, NE), out [M, N] bf16; route_rows % 128 == 0
// and M % route_rows == 0, the rest as above (checked by the wrapper). Pad
// rows (q = 0, scale 0) come out exactly 0, and so do the all-pad tail
// blocks, which name the last expert.
extern "C" int qs_w8a8_gemm_routed(const void* A, const void* W,
                                   const void* w_scale, const void* a_scale,
                                   const void* block_expert, void* out, int M,
                                   int N, int K, int route_rows, int splits,
                                   void* partials, void* arrivals,
                                   void* stream) {
  return launch<__nv_bfloat16>(A, W, w_scale, a_scale, block_expert, out, M,
                               N, K, route_rows, splits, partials, arrivals,
                               (cudaStream_t)stream);
}
