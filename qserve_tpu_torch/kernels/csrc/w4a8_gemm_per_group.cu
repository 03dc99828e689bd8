// W4A8 per-group GEMM (two-level progressive dequantization) for Hopper
// (sm_90a).
//
// Replaces: qserve_tpu/kernels/pallas_gemm.py w4a8_gemm_per_group_pallas and
// w4a8_gemm_per_group_whole_pallas. The TPU needed a second kernel for group
// counts that do not tile its sublanes (K = 11008: 43 groups a nibble
// plane); here one kernel serves every K with K % G == 0, groups that
// straddle the two nibble planes included (K/2 % G != 0: hidden 896 at
// g128). A second entry point replaces the routed MoE forms of both,
// w4a8_gemm_per_group_routed_pallas and
// w4a8_gemm_per_group_whole_routed_pallas (see the routed entry point
// below).
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
// from HBM (3.35 TB/s); at prefill (M = 2048..6144) the int8 tensor-core
// rate (1979 TOP/s dense).
//
// Design: the wgmma main loop of gemm_common.cuh with K2's B stage (a
// step's 32 packed rows by cp.async, 4x4 __byte_perm transposes by all 256
// threads) followed by the level-2 reconstruction on the K-major words, so
// the tensor cores see plain int8 x int8, as QServe's own CUDA kernel does,
// and no float z-term is needed. After the transpose a 32-bit word holds
// four k of one column n for each plane (low nibbles -> k, high -> k + 32),
// and the four k of a word lie in one group of that plane (G % 32 == 0 and
// K % 64 == 0), so one (s2, z2) pair serves the whole word: its bytes go
// into two 16-bit lanes, one 32-bit multiply-add by s2 and z2 forms
// q * s2 + z2 in each lane without a carry into the next (15 * 255 + 255
// < 2^16), and __byte_perm takes the low bytes back: exact mod 256 for any
// byte, as the plain version's int8 cast wraps. Each thread's four columns
// are fixed, so it keeps their s2 and z2 words of each plane's current
// group in registers, and loads the next group's one step ahead of its use,
// when that plane's 32 rows are about to enter it (per-plane counters, not
// divisions: a group may straddle the planes, K/2 % G != 0, e.g. hidden
// 896 at g128).

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

// q * s2 + z2 mod 256 for the four bytes of q (each < 16); s2 the byte in
// bits 0-7, zz the z2 byte in bits 0-7 and 16-23
__device__ __forceinline__ uint32_t level2(uint32_t even, uint32_t odd,
                                           uint32_t s2, uint32_t zz) {
  return __byte_perm(even * s2 + zz, odd * s2 + zz, 0x6240);
}

// The B stage: K2's copy and transpose, then the reconstruction
struct StageW4Group {
  static constexpr int kSlot = 32 * WG_WROW;
  const int8_t* __restrict__ W;   // [K/2, N] packed nibbles
  const int8_t* __restrict__ s2;  // [K/G, N] uint8 values
  const int8_t* __restrict__ z2;  // [K/G, N]
  int N, n0, G, K2, nsteps;       // K2 = K/2, the high plane's first k
  Quad t;
  bool live;                      // this thread's 4 columns lie inside N
  // each plane's next group and the packed row at which it starts: the
  // low plane's rows r are k = r, the high plane's k = K2 + r
  int lo_g, hi_g, lo_next, hi_next;
  uint32_t s2lo, z2lo, s2hi, z2hi;  // this thread's 4 columns, current groups
  uint32_t sel_s[4], sel_z[4];      // __byte_perm picks of column word jj

  // from step s0, the first of this block's K slice: each plane's group
  // of that step's first row, loaded at once
  __device__ __forceinline__ StageW4Group(const int8_t* W, const int8_t* s2,
                                          const int8_t* z2, int N, int K, int G,
                                          int s0)
      : W(W), s2(s2), z2(z2), N(N), n0(blockIdx.y * WG_BN), G(G), K2(K / 2),
        nsteps(K / 64), lo_g(s0 * 32 / G), hi_g((K / 2 + s0 * 32) / G),
        lo_next(s0 * 32), hi_next(s0 * 32) {
    live = n0 + 4 * t.cq < N;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint32_t c = (jj + t.f) & 3;
      sel_s[jj] = 0x4440u | c;
      sel_z[jj] = 0x4040u | c | (c << 8);
    }
    load(s0);
  }
  __device__ __forceinline__ uint32_t group_word(const int8_t* p, int g) const {
    return live ? __ldg(reinterpret_cast<const unsigned int*>(
                      p + (size_t)g * N + n0 + 4 * t.cq))
                : 0u;
  }
  // the (s2, z2) words step s needs, for each plane entering a new group
  __device__ __forceinline__ void load(int s) {
    const int r0 = s * 32;
    if (r0 == lo_next) {
      s2lo = group_word(s2, lo_g);
      z2lo = group_word(z2, lo_g);
      ++lo_g;
      lo_next = lo_g * G;
    }
    if (r0 == hi_next) {
      s2hi = group_word(s2, hi_g);
      z2hi = group_word(z2, hi_g);
      ++hi_g;
      hi_next = hi_g * G - K2;
    }
  }
  __device__ __forceinline__ void issue(int s, unsigned char* slot) const {
    const int wr = threadIdx.x >> 3, wc = (threadIdx.x & 7) * 16;
    const bool ok = n0 + wc < N;
    cp_async16(slot + wr * WG_WROW + wc,
               W + (size_t)(s * 32 + wr) * N + (ok ? n0 + wc : 0), ok);
  }
  __device__ __forceinline__ void convert(int s, const unsigned char* slot,
                                          unsigned char* bs) {
    uint32_t col[4];
    t.transpose(slot, col);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint32_t w = col[jj], o = t.offset(jj);
      *reinterpret_cast<uint32_t*>(bs + o) =  // k < 32: low nibbles
          level2(w & 0x000F000Fu, (w >> 8) & 0x000F000Fu,
                 __byte_perm(s2lo, 0u, sel_s[jj]), __byte_perm(z2lo, 0u, sel_z[jj]));
      *reinterpret_cast<uint32_t*>(bs + o + 256) =  // k + 32: high nibbles
          level2((w >> 4) & 0x000F000Fu, (w >> 12) & 0x000F000Fu,
                 __byte_perm(s2hi, 0u, sel_s[jj]), __byte_perm(z2hi, 0u, sel_z[jj]));
    }
    // the next step's group words, loaded after this step's last use so
    // their latency hides behind this step's products
    if (s + 1 < nsteps) load(s + 1);
  }
};

// One tile, over all of K or (kSplit) over the block's K slice, the stage
// starting at the slice's first step; the routed form's block reads its
// expert (route_rows % 128 == 0, checked by the wrapper): W ([NE, K/2, N]),
// s2 and z2 ([NE, K/G, N]) and s1 ([NE, N]) offset by its stride in size_t.
template <bool kSplit, typename OutT>
__device__ __forceinline__ void per_group_tile(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W,
    const int8_t* __restrict__ s2, const int8_t* __restrict__ z2,
    const float* __restrict__ s1, const float* __restrict__ a_scale,
    const int* __restrict__ block_expert, OutT* __restrict__ out, int M, int N,
    int K, int G, int route_rows, SplitK ws) {
  const size_t e =
      block_expert ? (size_t)block_expert[(blockIdx.x * WG_BM) / route_rows] : 0;
  const size_t group_stride = (size_t)(K / G) * N;
  const ScaleEpilogue<OutT> epilogue{s1 + e * N, a_scale, out};
  StageW4Group stage(W + e * (size_t)(K / 2) * N, s2 + e * group_stride,
                     z2 + e * group_stride, N, K, G,
                     kSplit ? k_slice(K / 64).s0 : 0);
  wgmma_gemm_tile<kSplit>(A, stage, epilogue, M, N, K, 32, K / 2, ws);
}

template <typename OutT>
__global__ void __launch_bounds__(WG_THREADS)
w4a8_gemm_per_group_kernel(const int8_t* __restrict__ A,
                           const int8_t* __restrict__ W,
                           const int8_t* __restrict__ s2,
                           const int8_t* __restrict__ z2,
                           const float* __restrict__ s1,
                           const float* __restrict__ a_scale,
                           const int* __restrict__ block_expert,
                           OutT* __restrict__ out, int M, int N, int K, int G,
                           int route_rows) {
  per_group_tile<false>(A, W, s2, z2, s1, a_scale, block_expert, out, M, N, K,
                        G, route_rows, SplitK{});
}

// the same with K split into gridDim.z slices (gemm_common.cuh)
template <typename OutT>
__global__ void __launch_bounds__(WG_THREADS)
w4a8_gemm_per_group_split_kernel(const int8_t* __restrict__ A,
                                 const int8_t* __restrict__ W,
                                 const int8_t* __restrict__ s2,
                                 const int8_t* __restrict__ z2,
                                 const float* __restrict__ s1,
                                 const float* __restrict__ a_scale,
                                 const int* __restrict__ block_expert,
                                 OutT* __restrict__ out, int M, int N, int K,
                                 int G, int route_rows, SplitK ws) {
  per_group_tile<true>(A, W, s2, z2, s1, a_scale, block_expert, out, M, N, K,
                       G, route_rows, ws);
}

template <typename OutT>
int launch(const void* A, const void* W, const void* s2, const void* z2,
           const void* s1, const void* a_scale, const void* block_expert,
           void* out, int M, int N, int K, int G, int route_rows, int splits,
           void* partials, void* arrivals, cudaStream_t st) {
  constexpr int smem = wgmma_smem<StageW4Group, ScaleEpilogue<OutT>>();
  const auto a = (const int8_t*)A, w = (const int8_t*)W;
  const auto q2 = (const int8_t*)s2, p2 = (const int8_t*)z2;
  const auto f1 = (const float*)s1, fs = (const float*)a_scale;
  const auto be = (const int*)block_expert;
  if (splits > 1)
    return launch_tiles<w4a8_gemm_per_group_split_kernel<OutT>>(
        smem, M, N, splits, st, a, w, q2, p2, f1, fs, be, (OutT*)out, M, N, K,
        G, route_rows, SplitK{(int4*)partials, (int*)arrivals});
  return launch_tiles<w4a8_gemm_per_group_kernel<OutT>>(
      smem, M, N, splits, st, a, w, q2, p2, f1, fs, be, (OutT*)out, M, N, K, G,
      route_rows);
}

}  // namespace

// A [M, K] int8, W [K/2, N] int8, s2/z2 [K/G, N] int8, s1 [N] f32,
// a_scale [M] f32, out [M, N] bf16 (out_f32 == 0) or f32; K % 64 == 0,
// N % 64 == 0, G % 32 == 0 and K % G == 0 (checked by the wrapper); splits,
// partials, arrivals: K2's (w4a8_gemm.cu).
extern "C" int qs_w4a8_gemm_per_group(const void* A, const void* W,
                                      const void* s2, const void* z2,
                                      const void* s1, const void* a_scale,
                                      void* out, int out_f32, int M, int N,
                                      int K, int G, int splits, void* partials,
                                      void* arrivals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return out_f32 ? launch<float>(A, W, s2, z2, s1, a_scale, nullptr, out, M,
                                 N, K, G, M, splits, partials, arrivals, st)
                 : launch<__nv_bfloat16>(A, W, s2, z2, s1, a_scale, nullptr,
                                         out, M, N, K, G, M, splits, partials,
                                         arrivals, st);
}

// The routed form for the MoE prefill dispatch: W [NE, K/2, N] int8, s2/z2
// [NE, K/G, N] int8, s1 [NE, N] f32, block_expert [M / route_rows] int32 in
// [0, NE), out [M, N] bf16; route_rows % 128 == 0 and M % route_rows == 0,
// the rest as above (checked by the wrapper). Pad rows (q = 0, scale 0)
// come out exactly 0, and so do the all-pad tail blocks, which name the
// last expert.
extern "C" int qs_w4a8_gemm_per_group_routed(const void* A, const void* W,
                                             const void* s2, const void* z2,
                                             const void* s1,
                                             const void* a_scale,
                                             const void* block_expert,
                                             void* out, int M, int N, int K,
                                             int G, int route_rows, int splits,
                                             void* partials, void* arrivals,
                                             void* stream) {
  return launch<__nv_bfloat16>(A, W, s2, z2, s1, a_scale, block_expert, out,
                               M, N, K, G, route_rows, splits, partials,
                               arrivals, (cudaStream_t)stream);
}
