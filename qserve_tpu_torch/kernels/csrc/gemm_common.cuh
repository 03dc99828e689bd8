// The one int8 tensor-core main loop of the quantized GEMM kernels
// (w4a8_gemm.cu: K2, w4a8_gemm_per_group.cu: K8, w8a8_gemm.cu: K9), dense
// and routed: wgmma_gemm_tile below, a template over a B-stage policy and an
// epilogue.
//
// A block of two warpgroups (256 threads) owns a 128x128 output tile; each
// warpgroup runs wgmma.mma_async m64n128k32 (s8 x s8 -> s32) on 64 of its
// rows. K is walked in steps of 64 logical k. The step's A tile ([128 m][64
// k] int8) and its bytes of W arrive by cp.async in a 4-slot ring, three
// steps in flight. s8 wgmma reads both operands K-major from shared memory,
// and every weight layout here is N-major ([K, N], or packed [K/2, N]), so
// each step all 256 threads turn the step's W bytes into the K-major [128
// n][64 k] int8 tile wgmma reads (the policy's `convert`): a thread loads
// 4x4 byte blocks, transposes each with __byte_perm (its byte order rotated
// by lane so that a warp's 32 stores hit 32 banks) and stores the columns.
// That tile is double-buffered, so the conversion of step s + 1 overlaps
// step s's products. Blocks walk M tiles fastest: the blocks in flight share
// a few weight column tiles (read from HBM once, then from L2) and all of A.
// The epilogue keeps its f32 operation order, stages the output tile in
// shared memory over the ring and stores 16-byte row runs.
//
// What bounds it on an H100: at decode (M <= 64) the weights, streamed once
// from HBM (3.35 TB/s); at prefill (M = 2048..6144) the int8 tensor-core
// rate (1979 TOP/s dense). At M = 2048 the loop reaches 19-27% of that
// rate (K8 to K2, scripts/ab_decode_gemm.py): each step a block also
// copies 12-16 KB from L2 and converts the weights between two block
// barriers, against ~256 cycles of tensor work.
//
// Split-K: where the tile grid leaves SMs idle (decode: M <= 128 is one M
// tile, so N / 128 blocks), the wrapper launches gridDim.z = S > 1 blocks a
// tile (kernels/gemm.py `split_k` picks S from M, N, K and the SM count).
// Block z walks the steps [z * nsteps / S, (z + 1) * nsteps / S) of K;
// every block of the tile stores its int32 partial sums and arrives at the
// tile's counter, and the last to arrive adds the others' partials to its
// own (integers: exact in any order), puts the counter back to 0 and alone
// runs the unchanged epilogue. So the output is the unsplit launch's bit for
// bit, and the workspace is clean again after every launch (CUDA graphs
// replay it as it is).
//
// A policy (`Stage`) gives kSlot, its ring bytes a step; issue(s, slot),
// every thread's cp.async copies of step s's W bytes; and convert(s, slot,
// bs), the K-major tile of step s. The 64 k of a step are two runs of 32
// columns of A: run 0 starts at s * a_step, run 1 at s * a_step + a_hi. The
// W4 kernels pair the low nibble plane with columns [0, K/2) and the high
// plane with [K/2, K) (a_step = 32, a_hi = K/2); the W8 kernel takes 64
// consecutive columns (a_step = 64, a_hi = 32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace qs_gemm {

using namespace qs_async;

constexpr int WG_BM = 128, WG_BN = 128;  // output tile
constexpr int WG_THREADS = 256;           // two warpgroups
constexpr int WG_STAGES = 4;              // ring slots of A and W
constexpr int WG_A = WG_BM * 64;          // A bytes a step: [128 m][64 k]
constexpr int WG_B = WG_BN * 64;          // the K-major [128 n][64 k] tile
constexpr int WG_LDC = WG_BN + 8;         // staged output row, elements
constexpr int WG_WROW = WG_BN + 16;       // a W row in the ring (16-byte pad)

// ---------------------------------------------------------------------------
// wgmma. A warpgroup (4 warps) issues wgmma.mma_async m64n128k32 (s8 x s8 ->
// s32) with both operands in shared memory, K-major, in the canonical
// no-swizzle layout: 8 rows x 16 bytes form one 128-byte core matrix; the
// two core matrices of a 32-byte k slice lie LBO = 128 bytes apart and
// successive 8-row groups SBO bytes apart.
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

// byte offset of (row r, k) in a K-major no-swizzle tile with 64 k a row:
// core matrices of 8 rows x 16 bytes, 4 along k (LBO 128), row groups 512
__device__ __forceinline__ int kmajor(int r, int k) {
  return (r >> 3) * 512 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// ---------------------------------------------------------------------------
// The conversion the policies share: thread -> a 4x4 byte block of a 32-row
// x 128-column slab of W (rows 4rq.., columns 4cq..), its stores rotated by
// f so a warp's 32 stores hit 32 banks. transpose's col[jj] holds column
// 4cq + ((jj + f) & 3), rows 4rq..4rq+3 (byte i: row 4rq + i).
// ---------------------------------------------------------------------------
struct Quad {
  int rq, cq, f;
  uint32_t rot;
  __device__ __forceinline__ Quad() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    rq = (lane >> 3) + 4 * (warp & 1);
    cq = ((warp >> 1) * 4 + ((lane >> 1) & 3)) * 2 + (lane & 1);
    f = (lane >> 1) & 3;
    rot = (f & 3) | (((f + 1) & 3) << 4) | (((f + 2) & 3) << 8) |
          (((f + 3) & 3) << 12);
  }
  // the 4x4 block of the slab at `slab` (row stride WG_WROW), transposed
  __device__ __forceinline__ void transpose(const unsigned char* slab,
                                            uint32_t (&col)[4]) const {
    const unsigned char* wp = slab + 4 * rq * WG_WROW + 4 * cq;
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = __byte_perm(*reinterpret_cast<const uint32_t*>(wp + i * WG_WROW), 0u, rot);
    const uint32_t t01l = __byte_perm(x[0], x[1], 0x5140);
    const uint32_t t01h = __byte_perm(x[0], x[1], 0x7362);
    const uint32_t t23l = __byte_perm(x[2], x[3], 0x5140);
    const uint32_t t23h = __byte_perm(x[2], x[3], 0x7362);
    col[0] = __byte_perm(t01l, t23l, 0x5410);
    col[1] = __byte_perm(t01l, t23l, 0x7632);
    col[2] = __byte_perm(t01h, t23h, 0x5410);
    col[3] = __byte_perm(t01h, t23h, 0x7632);
  }
  // where column word jj goes in the K-major tile (k 4rq..; + 256 for k + 32)
  __device__ __forceinline__ int offset(int jj) const {
    return kmajor(4 * cq + ((jj + f) & 3), 4 * rq);
  }
};

// ---------------------------------------------------------------------------
// The epilogues: out[row, col] = f(psum, row, col) in f32, rounded once.
// row(r) loads what a row needs, one(p, col, row) computes one element.
// ---------------------------------------------------------------------------

// out = (psum * w_scale[n]) * a_scale[m], each product rounded to nearest
// (no FMA contraction): K8 and K9, bf16 or f32 out
template <typename OutT>
struct ScaleEpilogue {
  using Out = OutT;
  const float* __restrict__ w_scale;
  const float* __restrict__ a_scale;
  Out* __restrict__ out;
  __device__ __forceinline__ float row(int r) const { return a_scale[r]; }
  __device__ __forceinline__ float one(int p, int col, float as) const {
    return __fmul_rn(__fmul_rn(__int2float_rn(p), w_scale[col]), as);
  }
};

// two adjacent outputs of one row into the staged tile, rounded once
__device__ __forceinline__ void stage2(__nv_bfloat16* c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void stage2(float* c, float a, float b) {
  *reinterpret_cast<float2*>(c) = make_float2(a, b);
}

// the dynamic shared memory of one block: the ring and the two K-major
// tiles, or the staged output tile if that is larger (f32)
template <class Stage, class Epi>
constexpr int wgmma_smem() {
  return WG_STAGES * (WG_A + Stage::kSlot) + 2 * WG_B >
                 WG_BM * WG_LDC * (int)sizeof(typename Epi::Out)
             ? WG_STAGES * (WG_A + Stage::kSlot) + 2 * WG_B
             : WG_BM * WG_LDC * (int)sizeof(typename Epi::Out);
}

// ---------------------------------------------------------------------------
// Split-K (see the top of this file)
// ---------------------------------------------------------------------------

// the split's workspace: a slot of partial sums per block of a split tile
// (16 int4 a thread, laid out [slot][16][256 threads] so every store and
// load is a coalesced 16-byte one) and an arrival counter per tile, 0
// between launches; both null when S = 1
struct SplitK {
  int4* partials;
  int* arrivals;
};

// this block's steps [s0, s1) of K's nsteps: slice blockIdx.z of gridDim.z
struct Steps {
  int s0, s1;
};
__device__ __forceinline__ Steps k_slice(int nsteps) {
  return {(int)blockIdx.z * nsteps / (int)gridDim.z,
          ((int)blockIdx.z + 1) * nsteps / (int)gridDim.z};
}

// Every block of the tile stores acc and arrives; the last to arrive adds
// the other blocks' partials into acc, resets the tile's counter and
// returns true: it alone runs the epilogue. The stores are made visible
// device-wide before the arrival (__threadfence), and the last block reads
// them from L2 (ld.global.cg), past its own L1.
__device__ __forceinline__ bool split_reduce(int (&acc)[64], SplitK ws) {
  __shared__ int last;
  const int S = gridDim.z, tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t slot = (size_t)tile * S;
  int4* mine = ws.partials + (slot + blockIdx.z) * 16 * WG_THREADS + threadIdx.x;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    __stcg(mine + j * WG_THREADS,
           make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ws.arrivals + tile, 1) == S - 1;
    if (last) ws.arrivals[tile] = 0;  // every block of the tile has arrived
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int z = 0; z < S; ++z) {
    if (z == (int)blockIdx.z) continue;
    const int4* p = ws.partials + (slot + z) * 16 * WG_THREADS + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int4 v = __ldcg(p + j * WG_THREADS);
      acc[4 * j] += v.x;
      acc[4 * j + 1] += v.y;
      acc[4 * j + 2] += v.z;
      acc[4 * j + 3] += v.w;
    }
  }
  return true;
}

// One block's 128x128 tile (M tile blockIdx.x, N tile blockIdx.y) of
// out = epilogue(A . W), A int8 [M, K] (K % 64 == 0), out [M, N]
// (N % 64 == 0), W whatever the policy reads. kSplit: over K slice
// blockIdx.z of gridDim.z, reduced in `ws`; else over all of K (the loop
// compiles as it did before the split existed: the ring is indexed by the
// slice's own step count i, s = s0 + i, and s0 = 0).
template <bool kSplit, class Stage, class Epi>
__device__ __forceinline__ void wgmma_gemm_tile(
    const int8_t* __restrict__ A, Stage& stage, const Epi& epilogue, int M,
    int N, int K, int a_step, int a_hi, SplitK ws) {
  extern __shared__ __align__(128) unsigned char wsm[];
  unsigned char* As = wsm;                             // [STAGES][WG_A]
  unsigned char* Ws = wsm + WG_STAGES * WG_A;          // [STAGES][kSlot]
  unsigned char* Bs = Ws + WG_STAGES * Stage::kSlot;   // [2][WG_B]
  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const Steps steps = kSplit ? k_slice(K / 64) : Steps{0, K / 64};
  const int nsteps = steps.s1 - steps.s0;

  // copies of the slice's step i (K's step s0 + i) into slot i % STAGES:
  // this warpgroup's 64 rows of A (two 16-byte granules a thread), and the
  // policy's bytes of W
  auto issue = [&](int i) {
    const int s = steps.s0 + i;
    unsigned char* as = As + (i % WG_STAGES) * WG_A;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tw + u * 128;
      const int r = wg * 64 + (i >> 2), part = i & 3;
      const int k = (part >> 1) * 32 + (part & 1) * 16;  // local k
      const int col = s * a_step + (part >> 1) * a_hi + (part & 1) * 16;
      const bool ok = m0 + r < M;
      cp_async16(as + kmajor(r, k), A + (size_t)(ok ? m0 + r : 0) * K + col, ok);
    }
    stage.issue(s, Ws + (i % WG_STAGES) * Stage::kSlot);
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

#pragma unroll
  for (int i = 0; i < WG_STAGES - 1; ++i) {
    if (i < nsteps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // step i landed; every wgmma of step i - 2 is done
    stage.convert(steps.s0 + i, Ws + (i % WG_STAGES) * Stage::kSlot,
                  Bs + (i & 1) * WG_B);
    fence_async_shared();
    __syncthreads();
    const unsigned char* as = As + (i % WG_STAGES) * WG_A + wg * 64 * 64;
    const unsigned char* bs = Bs + (i & 1) * WG_B;
#pragma unroll
    for (int j = 0; j < 64; ++j) fence_reg(acc[j]);
    wgmma_fence();
    wgmma_s8_m64n128k32(acc, wgmma_desc(as, 128, 512), wgmma_desc(bs, 128, 512));
    wgmma_s8_m64n128k32(acc, wgmma_desc(as + 256, 128, 512),
                        wgmma_desc(bs + 256, 128, 512));
    wgmma_commit();
    wgmma_wait<1>();  // step i - 1's products are done: its slot is free
#pragma unroll
    for (int j = 0; j < 64; ++j) fence_reg(acc[j]);
    if (i + WG_STAGES - 1 < nsteps) issue(i + WG_STAGES - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
  if (kSplit && !split_reduce(acc, ws)) return;

  // the output tile through shared memory (over the ring, which no copy or
  // product reads any more), then out in 16-byte row runs. WG_LDC: the 8
  // rows of a warp's bf16 pair stores, or of a half-warp's f32 pairs, on
  // distinct banks
  using Out = typename Epi::Out;
  Out* Cs = reinterpret_cast<Out*>(wsm);
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + (warp & 3) * 16 + g + 8 * half;
    const int row = m0 + r < M ? m0 + r : M - 1;  // a pad row is never stored
    const auto rs = epilogue.row(row);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * q, col = n0 + c < N ? n0 + c : N - 2;
      stage2(Cs + r * WG_LDC + c, epilogue.one(acc[4 * j + 2 * half], col, rs),
             epilogue.one(acc[4 * j + 2 * half + 1], col + 1, rs));
    }
  }
  __syncthreads();
  constexpr int V = 16 / sizeof(Out);  // elements a 16-byte run
#pragma unroll
  for (int i = tid; i < WG_BM * WG_BN / V; i += WG_THREADS) {
    const int r = i / (WG_BN / V), c = (i % (WG_BN / V)) * V;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(epilogue.out + (size_t)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(Cs + r * WG_LDC + c);
  }
}

// Launches a kernel of wgmma_gemm_tile on the grid of 128x128 tiles (M
// tiles fastest), `splits` K slices a tile, with `smem` bytes of dynamic
// shared memory (set once per kernel: above 48 KB it must be asked for);
// returns the launch's error.
template <auto Kernel, typename... Args>
inline int launch_tiles(int smem, int M, int N, int splits, cudaStream_t st,
                        Args... args) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, splits);
  Kernel<<<grid, WG_THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace qs_gemm
