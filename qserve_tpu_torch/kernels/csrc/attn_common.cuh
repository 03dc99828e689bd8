// What the attention kernels share (flash_attention.cu, paged_attention.cu,
// prefix_attention.cu): the dequantization of a cached KV code, in both
// cache modes, and the staging of bf16 K/V rows into shared memory.
//
// A cached value is code * scale + zero with the per-slot, per-head scale
// and zero, computed as the plain version computes it: the product rounded
// to nearest, then the sum (no FMA contraction).
//   KV4: a head's row is D/2 bytes, two UINT4 codes per byte, dims [0, D/2)
//        in the low nibbles and [D/2, D) in the high nibbles.
//   KV8: a head's row is D bytes, one UINT8 code u per value, stored as the
//        int8 u - 128 (so the code is the byte with its top bit flipped).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qs_attn {

constexpr float NEG_INF = -1e30f;

// element idx of a scales array that is bf16 or f32
__device__ __forceinline__ float load_scale(const void* scales, int scale_bf16,
                                            size_t idx) {
  return scale_bf16 ? __bfloat162float(((const __nv_bfloat16*)scales)[idx])
                    : ((const float*)scales)[idx];
}

__device__ __forceinline__ float dequant(uint32_t code, float sc, float zp) {
  return __fadd_rn(__fmul_rn((float)code, sc), zp);
}

__device__ __forceinline__ uint32_t kv8_code(uint32_t byte) {
  return byte ^ 0x80u;
}

// eight bf16 values (one 16-byte granule) into a shared-memory row
__device__ __forceinline__ void put8(__nv_bfloat16* dst, const int4& w) {
  *reinterpret_cast<int4*>(dst) = w;
}
__device__ __forceinline__ void put8(float* dst, const int4& w) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(b[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

// Stage BK rows [k0, k0 + BK) of head h of k and v ([T, H, D] bf16) into
// Ks/Vs [BK * D], as bf16 or widened to fp32; rows past T become 0. The
// whole block takes part, 16-byte loads.
template <int D, int BK, typename OutT>
__device__ __forceinline__ void stage_bf16_tile(
    OutT* Ks, OutT* Vs, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int k0, int T, int H, int h) {
  constexpr int GR = D / 8;  // granules per row
  for (int i = threadIdx.x; i < BK * GR; i += blockDim.x) {
    const int j = i / GR, gi = i % GR;
    const int s = k0 + j;
    int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
    if (s < T) {
      const size_t off = ((size_t)s * H + h) * D + gi * 8;
      kw = *reinterpret_cast<const int4*>(k + off);
      vw = *reinterpret_cast<const int4*>(v + off);
    }
    put8(Ks + j * D + gi * 8, kw);
    put8(Vs + j * D + gi * 8, vw);
  }
}

}  // namespace qs_attn
