// Causal flash attention over a packed varlen prefill stream, for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_flash_attention.py
// flash_prefill_attention_pallas.
//
// q [T, Hq, D], k/v [T, Hkv, D] bf16, seg [T] int32 (0 = padding, >0 =
// sequence id) -> out [T, Hq, D] bf16. Query row t attends key s when
// seg[s] == seg[t] > 0 and s <= t (and s > t - window when window > 0).
// Rows with no key to attend (padding) come out exactly 0, as in the TPU
// kernel (NEG_INF = -1e30 with l floored at 1e-30). Any T is accepted.
//
// What bounds it on an H100: causal attention at T = 2048 does about
// 2 * 2 * Hq * T^2 / 2 * D flops per layer, far above the bytes it moves
// (q, k, v, out once each), so it is bound by arithmetic: 989 TFLOP/s in
// bf16 on the tensor cores.
//
// Design: one block per (tile of 16 query tokens, kv head). The rep = Hq/Hkv
// query heads of that kv head fold into the block's rows (GQA), so each K/V
// tile staged in shared memory serves all of them. Four threads share a row
// and split head_dim in interleaved bf16 pairs (conflict-free shared reads);
// scores are reduced with two warp shuffles. Per 32-key tile the row keeps
// its scores in registers, rescales its fp32 accumulator once with the tile
// maximum (online softmax), then accumulates P.V. Key tiles stop at the
// causal limit of the query tile. The arithmetic is fp32 on the CUDA cores:
// this is the simple, correct version; moving QK^T and PV onto the tensor
// cores (mma/wgmma) is a later change.

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

constexpr int BQ = 16;   // query tokens per block
constexpr int BK = 32;   // keys per shared-memory tile

template <int D>
__global__ void flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v,
                                     const int* __restrict__ seg,
                                     __nv_bfloat16* __restrict__ out, int T,
                                     int Hq, int Hkv, float sm_scale,
                                     int window) {
  constexpr int NP = D / 8;  // bf16 pairs per thread (D / 4 dims)
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * D];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * D];
  __shared__ int segk[BK];

  const int rep = Hq / Hkv;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int hr = row / BQ, ti = row % BQ;
  const int qh = h * rep + hr;
  const int qpos = q0 + ti;
  const bool qvalid = qpos < T;
  const int qseg = qvalid ? seg[qpos] : 0;

  float2 qf[NP];
  float2 acc[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    acc[i] = make_float2(0.f, 0.f);
    qf[i] = make_float2(0.f, 0.f);
    if (qvalid) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
          q + ((size_t)qpos * Hq + qh) * D + 8 * i + 2 * sub);
      qf[i] = __bfloat1622float2(x);
    }
  }
  float m = NEG_INF, l = 0.f;

  const int qlast = min(q0 + BQ, T) - 1;
  int kstart = 0;
  if (window > 0) kstart = max(0, q0 - window + 1);
  kstart = (kstart / BK) * BK;

  for (int k0 = kstart; k0 <= qlast; k0 += BK) {
    stage_bf16_tile<D, BK>(Ks, Vs, k, v, k0, T, Hkv, h);
    for (int j = tid; j < BK; j += blockDim.x)
      segk[j] = (k0 + j < T) ? seg[k0 + j] : -1;
    __syncthreads();

    float s[BK];
    uint32_t valid = 0;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ks + j * D + 8 * i + 2 * sub));
        part = fmaf(qf[i].x, kf.x, part);
        part = fmaf(qf[i].y, kf.y, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = k0 + j;
      bool ok = qseg > 0 && segk[j] == qseg && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
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
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Vs + j * D + 8 * i + 2 * sub));
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
          out + ((size_t)qpos * Hq + qh) * D + 8 * i + 2 * sub) =
          __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
    }
  }
}

}  // namespace

// Threads per block = 4 * rep * BQ; the wrapper keeps rep <= 8 (at most 512
// threads, so the ~100 live registers of a thread do not spill) and
// D in {64, 128}.
extern "C" int qs_flash_prefill_attention(const void* q, const void* k,
                                          const void* v, const void* seg,
                                          void* out, int T, int Hq, int Hkv,
                                          int D, float sm_scale, int window,
                                          void* stream) {
  const int rep = Hq / Hkv;
  const dim3 grid((T + BQ - 1) / BQ, Hkv);
  const int threads = 4 * rep * BQ;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    flash_prefill_kernel<128><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out, T, Hq,
        Hkv, sm_scale, window);
  else if (D == 64)
    flash_prefill_kernel<64><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out, T, Hq,
        Hkv, sm_scale, window);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
