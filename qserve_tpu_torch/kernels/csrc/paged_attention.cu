// Paged quantized (KV4 or KV8) decode attention with fused dequantization,
// for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_paged_attention.py
// paged_decode_attention_pallas (and the batched epilogue of its dispatch
// that merges the current token's exact K/V, _paged_attn_dispatch).
//
// One query token per sequence. q [B, Hq, D] bf16; one layer of the cache:
// data int8 [P, 2, ps, H*Dc] (KV4: Dc = D/2, two values per byte, dims
// [0, D/2) in the low nibble and [D/2, D) in the high nibble; KV8: Dc = D,
// one byte u - 128 per value) and scales [P, 2, 2H, ps] in bf16 or f32
// (row h = per-slot scale of head h, row H+h = its zero);
// block_tables [B, maxP], context_lens [B] (including the current token),
// k_cur/v_cur [B, H, D] bf16 -> out [B, Hq, D] bf16. The cache holds
// positions < ctx-1; the current token is attended exactly from k_cur/v_cur.
// A row with ctx == 0 is padding and attends only its own k_cur/v_cur, as in
// the XLA fallback, so it stays finite.
//
// Unlike the TPU kernel, q and P stay fp32 here (the TPU kernel requantizes
// them to int8 for its MXU); this kernel follows the XLA fallback, which is
// the port's plain version.
//
// What bounds it on an H100: the bytes of the paged history, (Dc + 2 scale
// values) per key per head for K and for V, read once from HBM (3.35 TB/s).
//
// Design: one block of 128 threads per (sequence, kv head); the rep = Hq/H
// query heads of that kv head share each staged page chunk (GQA). The block
// walks its block table 64 keys at a time: it stages the cached K and V rows
// (16-byte loads) and the per-slot scales/zeros in shared memory, two
// threads per key dequantize the codes in registers (attn_common.cuh) and
// dot them against the fp32 query, the chunk's scores update an fp32 online
// softmax, and each thread accumulates P.V for one head_dim column of every
// query head. The current token is merged into (m, l, acc) at the end.

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

constexpr int THREADS = 128;
constexpr int CK = 64;      // keys per chunk (two threads per key)
constexpr int MAXREP = 8;   // query heads per kv head

template <int D, int BITS>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ data,
                    const void* __restrict__ scales, int scale_bf16,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens,
                    const __nv_bfloat16* __restrict__ k_cur,
                    const __nv_bfloat16* __restrict__ v_cur,
                    __nv_bfloat16* __restrict__ out, int Hq, int H, int ps,
                    int maxP, float sm_scale, int window) {
  constexpr int DC = D * BITS / 8;      // bytes of one head's row
  constexpr int LDK = DC + 16;   // shared row stride (16-byte aligned)
  constexpr int GR = DC / 16;    // 16-byte granules per row
  __shared__ __align__(16) uint8_t Kp[CK * LDK];
  __shared__ __align__(16) uint8_t Vp[CK * LDK];
  __shared__ float ksc[CK], kzp[CK], vsc[CK], vzp[CK];
  __shared__ float qs[MAXREP * D];
  __shared__ float S[MAXREP * CK];
  __shared__ float mrun[MAXREP], lrun[MAXREP], alph[MAXREP];
  __shared__ float red[MAXREP * (THREADS / 32)];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int rep = Hq / H;
  const int HDc = H * DC;
  const int hist = max(context_lens[b] - 1, 0);
  const int kbeg = window > 0 ? max(0, hist - window + 1) : 0;
  const int* table = block_tables + (size_t)b * maxP;

  for (int i = tid; i < rep * D; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)b * Hq + h * rep) * D + i]);
  if (tid < rep) {
    mrun[tid] = NEG_INF;
    lrun[tid] = 0.f;
  }
  float acc[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int c0 = (kbeg / CK) * CK; c0 < hist; c0 += CK) {
    for (int i = tid; i < CK * GR; i += THREADS) {
      const int j = i / GR, gi = i % GR, s = c0 + j;
      int4 kw = make_int4(0, 0, 0, 0), vw = make_int4(0, 0, 0, 0);
      if (s >= kbeg && s < hist) {
        const int page = table[s / ps], slot = s % ps;
        const int8_t* base =
            data + ((size_t)page * 2 * ps + slot) * HDc + h * DC + gi * 16;
        kw = *reinterpret_cast<const int4*>(base);
        vw = *reinterpret_cast<const int4*>(base + (size_t)ps * HDc);
      }
      *reinterpret_cast<int4*>(Kp + j * LDK + gi * 16) = kw;
      *reinterpret_cast<int4*>(Vp + j * LDK + gi * 16) = vw;
    }
    for (int j = tid; j < CK; j += THREADS) {
      const int s = c0 + j;
      float v4[4] = {0.f, 0.f, 0.f, 0.f};
      if (s >= kbeg && s < hist) {
        const int page = table[s / ps], slot = s % ps;
        // (kv, row): (0, h) k scale, (0, H+h) k zero, (1, h), (1, H+h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kv = e >> 1, rowi = (e & 1) ? H + h : h;
          const size_t idx = (((size_t)page * 2 + kv) * 2 * H + rowi) * ps + slot;
          v4[e] = load_scale(scales, scale_bf16, idx);
        }
      }
      ksc[j] = v4[0];
      kzp[j] = v4[1];
      vsc[j] = v4[2];
      vzp[j] = v4[3];
    }
    __syncthreads();

    // scores: two threads per key, each taking half of the cached row
    {
      const int j = tid >> 1, half = tid & 1;
      const float sc = ksc[j], zp = kzp[j];
      const uint8_t* rowp = Kp + j * LDK + half * (DC / 2);
      float dot[MAXREP];
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) dot[r] = 0.f;
#pragma unroll 4
      for (int w = 0; w < DC / 2; w += 4) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(rowp + w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = half * (DC / 2) + w + e;
          const uint32_t byte = (word >> (8 * e)) & 0xFFu;
          if constexpr (BITS == 4) {
            const float klo = dequant(byte & 0xFu, sc, zp);
            const float khi = dequant(byte >> 4, sc, zp);
#pragma unroll
            for (int r = 0; r < MAXREP; ++r) {
              if (r < rep) {
                dot[r] = fmaf(qs[r * D + idx], klo, dot[r]);
                dot[r] = fmaf(qs[r * D + idx + DC], khi, dot[r]);
              }
            }
          } else {
            const float kval = dequant(kv8_code(byte), sc, zp);
#pragma unroll
            for (int r = 0; r < MAXREP; ++r)
              if (r < rep) dot[r] = fmaf(qs[r * D + idx], kval, dot[r]);
          }
        }
      }
      const int s = c0 + j;
      const bool ok = s >= kbeg && s < hist;
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        const float tot = dot[r] + __shfl_xor_sync(0xffffffffu, dot[r], 1);
        if (r < rep && half == 0) S[r * CK + j] = ok ? tot * sm_scale : NEG_INF;
      }
    }
    __syncthreads();

    if (tid < rep) {
      float mc = NEG_INF;
      for (int j = 0; j < CK; ++j) mc = fmaxf(mc, S[tid * CK + j]);
      const float mn = fmaxf(mrun[tid], mc);
      alph[tid] = __expf(mrun[tid] - mn);
      mrun[tid] = mn;
    }
    __syncthreads();
    for (int i = tid; i < rep * CK; i += THREADS) {
      const float sv = S[i];
      S[i] = sv > 0.5f * NEG_INF ? __expf(sv - mrun[i / CK]) : 0.f;
    }
    __syncthreads();

    if (tid < rep) {
      float sum = 0.f;
      for (int j = 0; j < CK; ++j) sum += S[tid * CK + j];
      lrun[tid] = lrun[tid] * alph[tid] + sum;
    }
    if (tid < D) {
      // this thread's dim: byte tid of a KV8 row; in KV4 byte tid % DC,
      // low nibble for dims < D/2 and high nibble above
      const int bi = BITS == 4 ? tid % DC : tid;
      const bool hi = BITS == 4 && tid >= DC;
#pragma unroll
      for (int r = 0; r < MAXREP; ++r)
        if (r < rep) acc[r] *= alph[r];
      for (int j = 0; j < CK; ++j) {
        const uint32_t byte = Vp[j * LDK + bi];
        const uint32_t code =
            BITS == 4 ? (hi ? (byte >> 4) : (byte & 0xFu)) : kv8_code(byte);
        const float vv = dequant(code, vsc[j], vzp[j]);
#pragma unroll
        for (int r = 0; r < MAXREP; ++r)
          if (r < rep) acc[r] = fmaf(S[r * CK + j], vv, acc[r]);
      }
    }
    __syncthreads();
  }

  // merge the current token's exact K/V into (m, l, acc)
  const int warp = tid >> 5, lane = tid & 31;
  const size_t cur = ((size_t)b * H + h) * D;
  const float kc = tid < D ? __bfloat162float(k_cur[cur + tid]) : 0.f;
  const float vc = tid < D ? __bfloat162float(v_cur[cur + tid]) : 0.f;
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r >= rep) break;
    float part = tid < D ? qs[r * D + tid] * kc : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[r * (THREADS / 32) + warp] = part;
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= rep) break;
      float sc = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) sc += red[r * (THREADS / 32) + w];
      sc *= sm_scale;
      const float mn = fmaxf(mrun[r], sc);
      const float a = __expf(mrun[r] - mn), p = __expf(sc - mn);
      const float l = lrun[r] * a + p;
      const float o = (acc[r] * a + p * vc) / l;
      out[((size_t)b * Hq + h * rep + r) * D + tid] = __float2bfloat16_rn(o);
    }
  }
}

}  // namespace

// data/scales are ONE layer of the cache ([P, 2, ps, H*Dc], [P, 2, 2H, ps]).
// The wrapper keeps rep <= 8, D in {64, 128} and kv_bits in {4, 8}.
extern "C" int qs_paged_decode_attention(
    const void* q, const void* data, const void* scales, int scale_bf16,
    const void* block_tables, const void* context_lens, const void* k_cur,
    const void* v_cur, void* out, int B, int Hq, int H, int D, int kv_bits,
    int ps, int maxP, float sm_scale, int window, void* stream) {
  const dim3 grid(B, H);
  cudaStream_t st = (cudaStream_t)stream;
#define QS_LAUNCH(D_, BITS_)                                                 \
  paged_decode_kernel<D_, BITS_><<<grid, THREADS, 0, st>>>(                  \
      (const __nv_bfloat16*)q, (const int8_t*)data, scales, scale_bf16,      \
      (const int*)block_tables, (const int*)context_lens,                    \
      (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,              \
      (__nv_bfloat16*)out, Hq, H, ps, maxP, sm_scale, window)
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
