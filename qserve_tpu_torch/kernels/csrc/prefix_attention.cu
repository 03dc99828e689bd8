// Chunked-prefill attention over a quantized (KV4 or KV8) paged prefix plus
// the chunk itself, for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_prefix_attention.py
// prefix_prefill_attention_pallas.
//
// One prompt chunk of one sequence. q [T, Hq, D], k/v [T, Hkv, D] bf16 (the
// chunk's own rows, RoPE applied), seg [T] int32 (0 = padding), pos [T]
// int32 absolute positions; one layer of the cache: data int8
// [P, 2, ps, H*Dc] (KV4: Dc = D/2, dims [0, D/2) in the low nibble, [D/2, D)
// in the high nibble; KV8: Dc = D, one byte u - 128 per value) and scales
// [P, 2, 2H, ps] in bf16 or f32 (row h = per-slot scale of head h, row H+h =
// its zero); table [maxP] int32, the sequence's
// pages; prefix_len: positions [0, prefix_len) are cached -> out [T, Hq, D]
// bf16. Row t sees prefix key s when s < prefix_len, seg[t] > 0,
// s <= pos[t] (and s > pos[t] - window); it sees chunk key j when both rows
// are live and pos[j] <= pos[t] (and the window). One online softmax runs
// through both. Rows of padding attend nothing and come out 0.
//
// As in the paged decode kernel, q and P stay fp32 (the TPU kernel
// requantizes q and p.v_scale to int8 for its MXU) and codes dequantize
// as the plain version does (attn_common.cuh): __fmul_rn by the per-slot
// scale, then __fadd_rn of the zero.
//
// What bounds it on an H100: 4 * Hq * T * (S + T/2) * D flops against the
// bytes of the prefix pages (Dc + 2 scale values per key and head, K and V)
// and the chunk's q, k, v, out once each: arithmetic, 989 TFLOP/s in bf16
// on the tensor cores.
//
// Design: one block per (tile of 16 query tokens, kv head), the rep =
// Hq/Hkv query heads folded into the block's rows (the flash prefill
// kernel's layout), four threads per row splitting head_dim. A key tile is
// 32 keys staged in shared memory as fp32 together with each key's absolute
// position (INT_MAX = not a key), so one loop over tiles serves both phases:
// phase 1 walks the block table up to min(prefix_len, last query position
// + 1), dequantizing each packed 16-byte granule once while staging it;
// phase 2 walks the chunk's own key tiles up to the query tile (live rows
// are packed from row 0 with consecutive positions, so no later row can be
// visible). The arithmetic is fp32 on the CUDA cores: the simple, correct
// version; tensor cores are a later change.

#include <limits.h>

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

constexpr int BQ = 16;   // query tokens per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int MAX_THREADS = 4 * 8 * BQ;

template <int D, int BITS>
__global__ void __launch_bounds__(MAX_THREADS)
prefix_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      const int* __restrict__ pos,
                      const int8_t* __restrict__ data,
                      const void* __restrict__ scales, int scale_bf16,
                      const int* __restrict__ table,
                      __nv_bfloat16* __restrict__ out, int T, int Hq, int H,
                      int ps, int prefix_len, float sm_scale, int window) {
  constexpr int NP = D / 8;   // float pairs per thread (D / 4 dims)
  constexpr int DC = D * BITS / 8;      // bytes of one head's row
  constexpr int GR = DC / 16;  // 16-byte granules per cached row
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];
  __shared__ int kpos[BK];
  __shared__ int qpos_s[BQ];

  const int rep = Hq / H;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int hr = row / BQ, ti = row % BQ;
  const int qh = h * rep + hr;
  const int t = q0 + ti;
  const bool qvalid = t < T;
  const bool qlive = qvalid && seg[t] > 0;
  const int qp = qlive ? pos[t] : -1;

  if (tid < BQ) {
    const int tt = q0 + tid;
    qpos_s[tid] = (tt < T && seg[tt] > 0) ? pos[tt] : -1;
  }
  __syncthreads();
  int qmax = -1, qmin = INT_MAX;
#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    const int p = qpos_s[i];
    if (p >= 0) {
      qmax = max(qmax, p);
      qmin = min(qmin, p);
    }
  }

  float2 qf[NP];
  float2 acc[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    acc[i] = make_float2(0.f, 0.f);
    qf[i] = make_float2(0.f, 0.f);
    if (qvalid) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          q + ((size_t)t * Hq + qh) * D + 8 * i + 2 * sub);
      qf[i] = __bfloat1622float2(x);
    }
  }
  float m = NEG_INF, l = 0.f;

  // Tiles [0, n1) walk the cached prefix through the block table, tiles
  // [n1, n1 + n2) the chunk's own keys up to the query tile. All bounds are
  // block-uniform.
  const int hi = min(prefix_len, qmax + 1);
  const int lo = window > 0 ? (max(0, qmin - window + 1) / BK) * BK : 0;
  const int n1 = (qmax >= 0 && hi > lo) ? (hi - lo + BK - 1) / BK : 0;
  const int qlast = min(q0 + BQ, T) - 1;
  const int kstart = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n2 = qmax >= 0 ? (qlast - kstart) / BK + 1 : 0;
  const int HDc = H * DC;

  for (int it = 0; it < n1 + n2; ++it) {
    if (it < n1) {
      // stage 32 prefix keys: each cached 16-byte granule dequantized once
      const int c0 = lo + it * BK;
      for (int i = tid; i < 2 * BK * GR; i += blockDim.x) {
        const int kv = i / (BK * GR);
        const int j = (i / GR) % BK, gi = i % GR;
        const int s = c0 + j;
        float* dst = (kv ? Vs : Ks) + j * D + gi * 16;
        if (s < hi) {
          const int page = table[s / ps], slot = s % ps;
          const int4 w = *reinterpret_cast<const int4*>(
              data + (((size_t)page * 2 + kv) * ps + slot) * HDc + h * DC +
              gi * 16);
          const size_t si = (((size_t)page * 2 + kv) * 2 * H + h) * ps + slot;
          const float sc = load_scale(scales, scale_bf16, si);
          const float zp = load_scale(scales, scale_bf16, si + (size_t)H * ps);
          // 32 values in KV4 (16 low-nibble dims, 16 high-nibble dims), 16
          // in KV8. Written out here, not as a helper of attn_common.cuh:
          // nvcc 12.8 schedules the helper's KV4 form 13% slower.
          const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y,
                                     (uint32_t)w.z, (uint32_t)w.w};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const uint32_t byte = (words[e >> 2] >> (8 * (e & 3))) & 0xFFu;
            if constexpr (BITS == 4) {
              dst[e] = dequant(byte & 0xFu, sc, zp);
              dst[D / 2 + e] = dequant(byte >> 4, sc, zp);
            } else {
              dst[e] = dequant(kv8_code(byte), sc, zp);
            }
          }
        } else {  // a key past the end of the tile
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            dst[e] = 0.f;
            if constexpr (BITS == 4) dst[D / 2 + e] = 0.f;
          }
        }
      }
      for (int j = tid; j < BK; j += blockDim.x)
        kpos[j] = (c0 + j < hi) ? c0 + j : INT_MAX;
    } else {
      // stage 32 of the chunk's own keys (bf16 -> fp32)
      const int k0 = kstart + (it - n1) * BK;
      stage_bf16_tile<D, BK>(Ks, Vs, k, v, k0, T, H, h);
      for (int j = tid; j < BK; j += blockDim.x) {
        const int s = k0 + j;
        kpos[j] = (s < T && seg[s] > 0) ? pos[s] : INT_MAX;
      }
    }
    __syncthreads();

    // this thread's row against the tile: scores, online softmax, P.V
    float s[BK];
    uint32_t valid = 0;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 kf =
            *reinterpret_cast<const float2*>(Ks + j * D + 8 * i + 2 * sub);
        part = fmaf(qf[i].x, kf.x, part);
        part = fmaf(qf[i].y, kf.y, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = kpos[j];
      bool ok = qlive && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      s[j] = part * sm_scale;
      if (ok) {
        valid |= 1u << j;
        mt = fmaxf(mt, s[j]);
      }
    }
    if (valid) {
      const float m_new = fmaxf(m, mt);
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
      }
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        if (!(valid & (1u << j))) continue;
        const float p = __expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const float2 vf =
              *reinterpret_cast<const float2*>(Vs + j * D + 8 * i + 2 * sub);
          acc[i].x = fmaf(p, vf.x, acc[i].x);
          acc[i].y = fmaf(p, vf.y, acc[i].y);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (qvalid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)t * Hq + qh) * D + 8 * i + 2 * sub) =
          __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
    }
  }
}

}  // namespace

// data/scales are ONE layer of the cache ([P, 2, ps, H*Dc], [P, 2, 2H, ps]).
// Threads per block = 4 * rep * BQ; the wrapper keeps rep <= 8, D in
// {64, 128}, kv_bits in {4, 8} and prefix_len <= maxP * ps.
extern "C" int qs_prefix_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg,
    const void* pos, const void* data, const void* scales, int scale_bf16,
    const void* table, void* out, int T, int Hq, int H, int D, int kv_bits,
    int ps, int prefix_len, float sm_scale, int window, void* stream) {
  const int rep = Hq / H;
  const dim3 grid((T + BQ - 1) / BQ, H);
  const int threads = 4 * rep * BQ;
  cudaStream_t st = (cudaStream_t)stream;
#define QS_LAUNCH(D_, BITS_)                                                  \
  prefix_prefill_kernel<D_, BITS_><<<grid, threads, 0, st>>>(                 \
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                       \
      (const __nv_bfloat16*)v, (const int*)seg, (const int*)pos,              \
      (const int8_t*)data, scales, scale_bf16, (const int*)table,             \
      (__nv_bfloat16*)out, T, Hq, H, ps, prefix_len, sm_scale, window)
  if (D == 128 && kv_bits == 4)
    QS_LAUNCH(128, 4);
  else if (D == 128 && kv_bits == 8)
    QS_LAUNCH(128, 8);
  else if (D == 64 && kv_bits == 4)
    QS_LAUNCH(64, 4);
  else if (D == 64 && kv_bits == 8)
    QS_LAUNCH(64, 8);
  else
    return (int)cudaErrorInvalidValue;
#undef QS_LAUNCH
  return (int)cudaGetLastError();
}
