// What the attention kernels share (flash_attention.cu, paged_attention.cu,
// prefix_attention.cu): scale loads and cp.async copies of the cached KV
// pages, in both cache modes, and the tensor-core tile step of the two
// prefill kernels (the cp.async instructions are cp_async.cuh's).
//
// A cached value is code * scale + zero with the per-slot, per-head scale
// and zero; the kernels compute in the code domain (scale and zero applied
// to sums of codes).
//   KV4: a head's row is D/2 bytes, two UINT4 codes per byte, dims [0, D/2)
//        in the low nibbles and [D/2, D) in the high nibbles.
//   KV8: a head's row is D bytes, one UINT8 code u per value, stored as the
//        int8 u - 128 (so the code is the byte with its top bit flipped).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace qs_attn {

using namespace qs_async;

constexpr float NEG_INF = -1e30f;

// element idx of a scales array that is bf16 or f32
__device__ __forceinline__ float load_scale(const void* scales, int scale_bf16,
                                            size_t idx) {
  return scale_bf16 ? __bfloat162float(((const __nv_bfloat16*)scales)[idx])
                    : ((const float*)scales)[idx];
}

// ---------------------------------------------------------------------------
// Tensor-core tiles of the prefill kernels (K3 flash_attention.cu, K6
// prefix_attention.cu). Each warp owns 16 of the block's folded query rows
// (row r = head (r / bq) of the kv head's group, token q0 + r % bq; K3 has 4
// warps, K6 8) and runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) against
// 64-key tiles in shared memory, [64][D + 8] bf16: the 8-element pad puts
// the 8 rows an ldmatrix reads on 8 distinct 16-byte bank groups.
// Fragment layouts are PTX's for m16n8k16: thread (g = lane / 4, t = lane
// % 4) holds rows g and g + 8, columns 2t, 2t + 1 (+ 8).
// ---------------------------------------------------------------------------

constexpr int BK = 64;    // keys per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;

// Copy keys [k0, k0 + BK) of kv head h of k and v ([T, H, D] bf16) into the
// tiles Ks and Vs ([BK][D + 8]) by cp.async, NTHREADS threads taking 16-byte
// chunks in turn; keys past T are zero-filled. The caller commits.
template <int D, int NTHREADS>
__device__ __forceinline__ void stage_bf16_tile_async(
    __nv_bfloat16* Ks, __nv_bfloat16* Vs, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int k0, int T, int H, int h) {
  constexpr int LD = D + 8, CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int u = 0; u < BK * CH / NTHREADS; ++u) {
    const int i = threadIdx.x + u * NTHREADS;
    const int j = i / CH, ch = i % CH, s = k0 + j;
    const bool ok = s < T;
    const size_t off = ((size_t)(ok ? s : 0) * H + h) * D + ch * 8;
    cp_async16(Ks + j * LD + ch * 8, k + off, ok);
    cp_async16(Vs + j * LD + ch * 8, v + off, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of rows g and g + 8 of this warp, straight from global
// memory (once per block); a null row is zeros.
template <int D>
__device__ __forceinline__ void load_q_frags(
    uint32_t (&qa)[D / 16][4], const __nv_bfloat16* const (&row)[2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16* p = row[e & 1];
      qa[kk][e] = p ? *reinterpret_cast<const uint32_t*>(
                          p + kk * 16 + (e >> 1) * 8 + 2 * t4)
                    : 0u;
    }
}

// One warp's 16 rows against one tile (Ks, Vs: [BK][D + 8] bf16), online
// softmax in the log2 domain. score(acc, i, j) turns the f32 dot of row
// g + 8i with key j into a log2-domain score, or NEG_INF where masked.
// weight(p, i, j) is what multiplies V's row j; it is rounded to bf16 for the
// product, as the TPU kernel rounds P (`p.astype(v.dtype)`). l sums the
// unrounded p; z is a second per-row sum rescaled with l (K6's sum of
// p * zero). A tile that masks all 16 rows returns before PV.
template <int D, class Score, class Weight>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qa)[D / 16][4], const __nv_bfloat16* Ks,
    const __nv_bfloat16* Vs, Score score, Weight weight, float (&m)[2],
    float (&l)[2], float (&z)[2], float (&o)[D / 8][4]) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // S = Q K^T: per 16-wide slice of D, four x4 loads of 16 keys each
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              Ks + (nb * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                  ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nb], qa[kk], b0, b1);
      mma_bf16(s[2 * nb + 1], qa[kk], b2, b3);
    }
  }
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[j][c] = score(s[j][c], c >> 1, 8 * j + 2 * t4 + (c & 1));
      mt[c >> 1] = fmaxf(mt[c >> 1], s[j][c]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
  }
  if (__all_sync(0xffffffffu, mt[0] == NEG_INF && mt[1] == NEG_INF)) return;
  float mn[2], base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mn[i] = fmaxf(m[i], mt[i]);
    // a row that has seen no key keeps max NEG_INF: measure its (all
    // masked) scores from 0, so each exp2 is of ~NEG_INF and comes out 0
    base[i] = mn[i] == NEG_INF ? 0.f : mn[i];
  }
  // rescale only when some row's max moved (most tiles after the first few)
  if (!__all_sync(0xffffffffu, mn[0] == m[0] && mn[1] == m[1])) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = fast_exp2(m[i] - mn[i]);
      l[i] *= alpha;
      z[i] *= alpha;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }
  }
  m[0] = mn[0], m[1] = mn[1];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c >> 1;
      const float p = fast_exp2(s[j][c] - base[i]);
      l[i] += p;
      s[j][c] = weight(p, i, 8 * j + 2 * t4 + (c & 1));
    }
  // O += P V: the S accumulators of keys 16kk..16kk+15 are P's A fragment
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3,
                Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                    dn * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dn], pa, b0, b1);
      mma_bf16(o[2 * dn + 1], pa, b2, b3);
    }
  }
}

// Rows g and g + 8: out = (o + z) / l in bf16 into dst (null = not a row of
// the output). A row that saw no key has l = 0 and comes out exactly 0.
template <int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4],
                                           float (&l)[2], float (&z)[2],
                                           __nv_bfloat16* const (&dst)[2]) {
  const int t4 = threadIdx.x & 3;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!dst[i]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst[i] + 8 * j + 2 * t4) =
          __floats2bfloat162_rn((o[j][2 * i] + z[i]) * inv[i],
                                (o[j][2 * i + 1] + z[i]) * inv[i]);
  }
}


}  // namespace qs_attn
