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
// Design: a 128x128 output tile per block of two warpgroups, each running
// wgmma m64n128k32 (s8 x s8 -> s32) on 64 of the rows, at every M (at M = 8
// and 64 it measured 2-2.4x faster than the earlier 64x64 mma.sync loop,
// whose tiles it wastes half of: scripts/ab_decode_gemm.py). K is walked in
// steps of 32 packed rows (64 logical k): A's two 32-column runs (at s*32
// and K/2 + s*32) and the packed rows arrive by cp.async in a 4-slot ring,
// three steps in flight (3 slots measured 3% slower). s8 wgmma reads both
// operands K-major from shared memory, and the packed weights are N-major,
// so every step all 256 threads turn the step's packed 32 x 128 bytes into
// the K-major [n][k] int8 tile wgmma reads: each thread loads a 4x4 byte
// block, transposes it with __byte_perm and splits the nibbles with
// 0x0F0F0F0F masks (low plane -> k 0..31, high -> k 32..63), two 32-bit
// stores a column (rotated by thread so the 32 stores of a warp hit 32
// banks). The unpacked tile is double-buffered: the conversion of step
// s + 1 overlaps step s's wgmma. The weights cross HBM at 4 bits. Blocks
// walk M tiles fastest, so those in flight share a few weight column tiles
// (5% faster than N tiles fastest at gate_up, M = 2048). The epilogue keeps
// its f32 operation order, stages its bf16 tile in shared memory and stores
// 16-byte row runs (5% faster than 4-byte stores from the accumulators).
// The routed form runs the same loop: its blocks are whole 128-row tiles
// (the engine routes in 256-row blocks), and each block reads its expert.

#include "gemm_common.cuh"

using namespace qs_gemm;

namespace {

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
};

// ---- the wgmma loop --------------------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128;  // output tile
constexpr int WG_THREADS = 256;           // two warpgroups
constexpr int WG_STAGES = 4;              // ring slots of A and packed W
constexpr int WG_A = WG_BM * 64;          // A bytes a step: [128 m][64 k]
constexpr int WG_WPS = WG_BN + 16;        // packed row stride (16-byte pad)
constexpr int WG_W = 32 * WG_WPS;         // packed W bytes a step
constexpr int WG_B = WG_BN * 64;          // unpacked [128 n][64 k]
constexpr int WG_SMEM = WG_STAGES * (WG_A + WG_W) + 2 * WG_B;

// byte offset of (row r, k) in a K-major no-swizzle tile with 64 k a row:
// core matrices of 8 rows x 16 bytes, 4 along k (LBO 128), row groups 512
__device__ __forceinline__ int kmajor(int r, int k) {
  return (r >> 3) * 512 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// One block's 128x128 tile of out = epilogue(A . unpack(W)); W [K/2, N].
__device__ __forceinline__ void w4a8_wgmma_tile(
    const int8_t* __restrict__ A, const int8_t* __restrict__ W,
    const PerChnEpilogue& epilogue, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char wsm[];
  unsigned char* As = wsm;                              // [STAGES][WG_A]
  unsigned char* Ws = wsm + WG_STAGES * WG_A;           // [STAGES][WG_W]
  unsigned char* Bs = Ws + WG_STAGES * WG_W;            // [2][WG_B]
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int warp = tid >> 5, lane = tid & 31;
  // M tiles vary fastest: the blocks in flight share a few weight column
  // tiles (read from HBM once, then L2) and all of A
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int K2 = K / 2, nsteps = K / 64;

  // copies of step s into slot s % STAGES: this warpgroup's 64 rows of A
  // (two 16-byte granules a thread), one 16-byte granule of packed W
  auto issue = [&](int s) {
    unsigned char* as = As + (s % WG_STAGES) * WG_A;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tw + u * 128;
      const int r = wg * 64 + (i >> 2), part = i & 3;
      const int k = (part >> 1) * 32 + (part & 1) * 16;  // local k
      const int col = s * 32 + (part >> 1) * K2 + (part & 1) * 16;
      const bool ok = m0 + r < M;
      cp_async16(as + kmajor(r, k), A + (size_t)(ok ? m0 + r : 0) * K + col, ok);
    }
    const int wr = tid >> 3, wc = (tid & 7) * 16;
    const bool ok = n0 + wc < N;
    cp_async16(Ws + (s % WG_STAGES) * WG_W + wr * WG_WPS + wc,
               W + (size_t)(s * 32 + wr) * N + (ok ? n0 + wc : 0), ok);
  };

  // the unpack: thread -> a 4x4 block (rows 4rq.., columns 4cq..), its
  // stores rotated by f so a warp's 32 stores hit 32 banks
  const int rq = (lane >> 3) + 4 * (warp & 1);
  const int cq = ((warp >> 1) * 4 + ((lane >> 1) & 3)) * 2 + (lane & 1);
  const int f = (lane >> 1) & 3;
  const uint32_t rot = ((f & 3) | (((f + 1) & 3) << 4) | (((f + 2) & 3) << 8) |
                        (((f + 3) & 3) << 12));
  auto unpack = [&](int s) {
    const unsigned char* wp = Ws + (s % WG_STAGES) * WG_W + 4 * rq * WG_WPS + 4 * cq;
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = __byte_perm(*reinterpret_cast<const uint32_t*>(wp + i * WG_WPS), 0u, rot);
    const uint32_t t01l = __byte_perm(x[0], x[1], 0x5140);
    const uint32_t t01h = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t t23l = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t t23h = __byte_perm(x[2], x[3], 0x7362);
    // col[jj]: rows 4rq..4rq+3 of column 4cq + ((jj + f) & 3)
    const uint32_t col[4] = {__byte_perm(t01l, t23l, 0x5410),
                             __byte_perm(t01l, t23l, 0x7632),
                             __byte_perm(t01h, t23h, 0x5410),
                             __byte_perm(t01h, t23h, 0x7632)};
    unsigned char* bs = Bs + (s & 1) * WG_B;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int o = kmajor(4 * cq + ((jj + f) & 3), 4 * rq);
      *reinterpret_cast<uint32_t*>(bs + o) = col[jj] & 0x0F0F0F0Fu;            // k < 32
      *reinterpret_cast<uint32_t*>(bs + o + 256) = (col[jj] >> 4) & 0x0F0F0F0Fu;  // k + 32
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // step s landed; every wgmma of step s - 2 is done
    unpack(s);
    fence_async_shared();
    __syncthreads();
    const unsigned char* as = As + (s % WG_STAGES) * WG_A + wg * 64 * 64;
    const unsigned char* bs = Bs + (s & 1) * WG_B;
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
    wgmma_fence();
    wgmma_s8_m64n128k32(acc, wgmma_desc(as, 128, 512), wgmma_desc(bs, 128, 512));
    wgmma_s8_m64n128k32(acc, wgmma_desc(as + 256, 128, 512),
                        wgmma_desc(bs + 256, 128, 512));
    wgmma_commit();
    wgmma_wait<1>();  // step s - 1's products are done: its slot is free
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
    if (s + WG_STAGES - 1 < nsteps) issue(s + WG_STAGES - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);

  // the epilogue's bf16 tile through shared memory (over the ring, which no
  // copy or product reads any more), then out in 16-byte row runs
  constexpr int LDC = WG_BN + 8;  // bf16; 8 rows of a warp on distinct banks
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(wsm);
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + (warp & 3) * 16 + g + 8 * half;
    const int row = m0 + r < M ? m0 + r : M - 1;  // a pad row is never stored
    const float as = epilogue.a_scale[row], asum = epilogue.a_sum[row];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * q, col = n0 + c < N ? n0 + c : N - 2;
      *reinterpret_cast<__nv_bfloat162*>(Cs + r * LDC + c) = __floats2bfloat162_rn(
          epilogue.one(acc[4 * j + 2 * half], col, as, asum),
          epilogue.one(acc[4 * j + 2 * half + 1], col + 1, as, asum));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < WG_BM * WG_BN / 8; i += WG_THREADS) {
    const int r = i / (WG_BN / 8), c = (i % (WG_BN / 8)) * 8;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(epilogue.out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(Cs + r * LDC + c);
  }
}

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
  const PerChnEpilogue epilogue{s1 + e * N, sz + e * N, a_scale, a_sum, out, N};
  w4a8_wgmma_tile(A, W + e * (size_t)(K / 2) * N, epilogue, M, N, K);
}

int launch_wgmma(const void* A, const void* W, const void* s1, const void* sz,
                 const void* a_scale, const void* a_sum, const void* block_expert,
                 void* out, int M, int N, int K, int route_rows,
                 cudaStream_t st) {
  static bool attr = false;  // dynamic shared memory above 48 KB
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a8_gemm_per_chn_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN);
  w4a8_gemm_per_chn_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, st>>>(
      (const int8_t*)A, (const int8_t*)W, (const float*)s1, (const float*)sz,
      (const float*)a_scale, (const float*)a_sum, (const int*)block_expert,
      (__nv_bfloat16*)out, M, N, K, route_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// A [M, K] int8, W [K/2, N] int8, s1/sz [N] f32, a_scale/a_sum [M] f32,
// out [M, N] bf16; K % 64 == 0 and N % 64 == 0 (checked by the wrapper).
extern "C" int qs_w4a8_gemm_per_chn(const void* A, const void* W,
                                    const void* s1, const void* sz,
                                    const void* a_scale, const void* a_sum,
                                    void* out, int M, int N, int K,
                                    void* stream) {
  return launch_wgmma(A, W, s1, sz, a_scale, a_sum, nullptr, out, M, N, K, M,
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
  return launch_wgmma(A, W, s1, sz, a_scale, a_sum, block_expert, out, M, N, K,
                      route_rows, (cudaStream_t)stream);
}
