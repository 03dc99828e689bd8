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
// What bounds it on an H100: 4 * Hq * D flops per live (query, key) pair,
// T * (S + T/2) pairs, against the bytes of the prefix pages (Dc + 2 scale
// values per key and head, K and V) and the chunk's q, k, v, out once each:
// arithmetic, 989 TFLOP/s in bf16 on the tensor cores.
//
// Design: the layout of the flash prefill kernel (attn_common.cuh) with
// twice its rows: one block of 8 warps per (kv head, tile of 128 / rep
// query tokens), the rep query heads folded into 128 rows, mma.sync
// m16n8k16 on bf16 for QK^T and PV, latest query tile first. What keeps it
// above the bound: every query tile reads and converts the whole prefix of
// its kv head, and mma.sync with two resident warps a scheduler reaches a
// fraction of the tensor cores' rate. The prefix is computed in the code
// domain, as the TPU kernel does: with codes c, per-slot scale sc and zero z,
//   q.k_s = sc_s (q.c_s) + z_s sum(q),
//   sum_s p_s v_s = sum_s (p_s sc_s) c_s + sum_s p_s z_s,
// so the tensor cores multiply bf16 q by raw codes and bf16-rounded p * sc
// by raw V codes; the scales never touch the tiles. The codes are centred
// on 0, exact in bf16 (KV4 n - 8 in -8..7, KV8 the stored signed byte
// u - 128), with the offset x sc folded into the zero: the rounding of
// p * sc then scales with |c| <= 8 and not 15, a third of the error.
// Phase 1 walks the prefix in 64-key tiles through the block table: the
// packed bytes (64 x Dc per K and per V) are copied by cp.async, double-
// buffered, each key's page looked up while staging (a tile may straddle
// pages), and every block turns each packed byte into bf16 codes once, in
// shared memory, for its eight warps. Phase 2 runs the chunk's own bf16 keys
// as the flash kernel does (bf16 P), carrying the softmax state over. The
// per-key scales and positions are loaded into registers a tile ahead and
// stored after the previous tile's compute. A prefix tile that every live row
// of the block sees whole skips the mask.

#include <limits.h>

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

// four packed KV4 bytes -> their low and high nibbles n as bf16 n - 8
__device__ __forceinline__ void kv4_to_bf16(uint32_t w, uint32_t (&lo)[2],
                                            uint32_t (&hi)[2]) {
  // 0x43nn is the bf16 128 + nn; subtracting 136 leaves nn - 8 exactly
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const uint32_t l4 = w & 0x0F0F0F0Fu, h4 = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t x[4] = {__byte_perm(l4, 0x43434343u, 0x5140),
                         __byte_perm(l4, 0x43434343u, 0x7362),
                         __byte_perm(h4, 0x43434343u, 0x5140),
                         __byte_perm(h4, 0x43434343u, 0x7362)};
  uint32_t y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x[e]), bias);
    y[e] = *reinterpret_cast<const uint32_t*>(&d);
  }
  lo[0] = y[0], lo[1] = y[1], hi[0] = y[2], hi[1] = y[3];
}

// four stored KV8 bytes b (the signed u - 128) -> their values as bf16:
// 0x43 | (b & 0x7F) is 128 + (b & 0x7F), 0x43 | (b & 0x80) is 128 or 256,
// and their difference is b, exactly
__device__ __forceinline__ void kv8_to_bf16(uint32_t w, uint32_t (&out)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t p = __byte_perm(w, 0u, e ? 0x4342 : 0x4140);  // 2 bytes, 16-bit lanes
    const uint32_t x = (p & 0x007F007Fu) | 0x43004300u;
    const uint32_t y = (p & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                     *reinterpret_cast<const __nv_bfloat162*>(&y));
    out[e] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// warps per block, each owning 16 folded query rows: 128 rows read and
// convert each prefix tile once for 2x the rows of the flash kernel's 64
// (measured 7% faster at the 8B chunk, scripts/ablate_prefix_attention.py)
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
// slots of the copy ring: tile it + 1 loads while tile it computes (a third
// slot, two tiles in flight, measured no faster)
constexpr int STAGES = 2;

template <int D, int BITS>
__global__ void __launch_bounds__(NT)
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
  constexpr int LD = D + 8;
  constexpr int DC = D * BITS / 8;  // bytes of one head's cached row
  constexpr int CPR = DC / 16;      // 16-byte chunks per cached row
  // 16-byte chunks of a K and V tile, and per thread (D = 96 at KV4: 1.5,
  // the last round masked)
  constexpr int NCOPY = 2 * BK * CPR, NU = (NCOPY + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][K,V][BK][LD]
  int8_t* packed = reinterpret_cast<int8_t*>(tiles + STAGES * 2 * BK * LD);  // [STAGES][K,V][BK][DC]
  float4* meta = reinterpret_cast<float4*>(packed + STAGES * 2 * BK * DC);  // [2][BK]
  int* kpos = reinterpret_cast<int*>(meta + 2 * BK);  // [2][BK]
  __shared__ int qrange[2];

  const int rep = Hq / H;
  // rep x bq of the 16 x WARPS rows live; a rep that does not divide them
  // (3, 5, 6, 7) leaves the rest dead (masked, never written)
  const int bq = 16 * WARPS / rep;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // latest tile first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float c = sm_scale * LOG2E;

  int qp[2];
  const __nv_bfloat16* qrow[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int hr = r / bq, t = q0 + r % bq;
    const bool ok = hr < rep && t < T;
    const size_t off = ((size_t)t * Hq + h * rep + hr) * D;
    qp[i] = ok && seg[t] > 0 ? pos[t] : -1;  // -1 sees no key
    qrow[i] = ok ? q + off : nullptr;
    orow[i] = ok ? out + off : nullptr;
  }
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, qrow);
  float sqc[2];  // sum(q) of each row, in the log2 score domain
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = i; e < 4; e += 2) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]));
        sum += f.x + f.y;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sqc[i] = sum * c;
  }

  // the live positions of the block's tokens bound both key loops
  if (tid == 0) qrange[0] = INT_MAX, qrange[1] = -1;
  __syncthreads();
  if (tid < bq && q0 + tid < T && seg[q0 + tid] > 0) {
    atomicMin(&qrange[0], pos[q0 + tid]);
    atomicMax(&qrange[1], pos[q0 + tid]);
  }
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  // Tiles [0, n1) walk the cached prefix [lo, hi) through the block table,
  // tiles [n1, n1 + n2) the chunk's own keys up to the query tile (live rows
  // are packed from row 0 with consecutive positions, so no later row can be
  // visible). All bounds are block-uniform.
  const int hi = min(prefix_len, qmax + 1);
  const int lo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int n1 = (qmax >= 0 && hi > lo) ? (hi - lo + BK - 1) / BK : 0;
  const int qlast = min(q0 + bq, T) - 1;
  const int kstart = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n2 = qmax >= 0 ? (qlast - kstart) / BK + 1 : 0;
  const int n = n1 + n2;
  const size_t HDc = (size_t)H * DC;
  // a key's page and slot: shifts for a power-of-two page size (the lookups
  // of a tile measured 5-7% of the kernel as divisions,
  // scripts/ab_prefill_attention.py page_division)
  const bool pow2 = (ps & (ps - 1)) == 0;
  const int sh = __ffs(ps) - 1;
  auto page_of = [&](int s) { return pow2 ? s >> sh : s / ps; };
  auto slot_of = [&](int s) { return pow2 ? s & (ps - 1) : s % ps; };

  // Issue tile it's copies into ring slot it % STAGES.
  auto issue = [&](int it) {
    const int b = it % STAGES;
    if (it < n1) {
      const int c0 = lo + it * BK;
      // every page lookup first, then every copy: the lookups overlap
      const int8_t* src[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int i = tid + u * NT;
        const int kv = i / (BK * CPR), j = (i / CPR) % BK, ch = i % CPR;
        const int s = c0 + j;
        src[u] = s < hi && i < NCOPY
                     ? data + (((size_t)table[page_of(s)] * 2 + kv) * ps + slot_of(s)) *
                                  HDc + h * DC + ch * 16
                     : nullptr;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int i = tid + u * NT;
        if (NCOPY % NT && i >= NCOPY) break;
        const int kv = i / (BK * CPR), j = (i / CPR) % BK, ch = i % CPR;
        cp_async16(packed + ((b * 2 + kv) * BK + j) * DC + ch * 16, src[u] ? src[u] : data,
                   src[u] != nullptr);
      }
    } else {
      stage_bf16_tile_async<D, NT>(tiles + (b * 2) * BK * LD,
                                   tiles + (b * 2 + 1) * BK * LD, k, v,
                                   kstart + (it - n1) * BK, T, H, h);
    }
  };
  // Threads < BK fetch tile it's key tid's scales and position into
  // registers (pre, kp) a tile ahead; put_meta stores them.
  float pre[4] = {0.f, 0.f, 0.f, 0.f};
  int kp = INT_MAX;
  auto fetch_meta = [&](int it) {
    if (tid >= BK) return;
    if (it < n1) {
      const int s = lo + it * BK + tid;
      kp = INT_MAX;
      pre[0] = pre[1] = pre[2] = pre[3] = 0.f;
      if (s < hi) {
        const int page = table[page_of(s)], slot = slot_of(s);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // K scale, K zero, V scale, V zero
          pre[e] = load_scale(
              scales, scale_bf16,
              (((size_t)page * 2 + (e >> 1)) * 2 * H + (e & 1) * H + h) * ps + slot);
        kp = s;
      }
    } else {
      const int s = kstart + (it - n1) * BK + tid;
      kp = (s < T && seg[s] > 0) ? pos[s] : INT_MAX;
    }
  };
  // per key: K scale x c, K zero, V scale, V zero; the codes are centred on
  // 0 (KV4 n - 8, KV8 the signed byte u - 128), the offset x scale folded
  // into each zero
  auto put_meta = [&](int it) {
    if (tid >= BK) return;
    constexpr float off = BITS == 8 ? 128.f : 8.f;
    meta[(it & 1) * BK + tid] = make_float4(pre[0] * c, pre[1] + off * pre[0], pre[2],
                                            pre[3] + off * pre[2]);
    kpos[(it & 1) * BK + tid] = kp;
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // STAGES - 1 tiles in flight; one commit group a tile (empty past the
  // end), so waiting for all but the newest STAGES - 1 groups is tile it
  if (n > 0) {
    fetch_meta(0);
    put_meta(0);
  }
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n) issue(it);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    const int b = it % STAGES;
    if (it + STAGES - 1 < n) issue(it + STAGES - 1);
    cp_async_commit();
    if (it + 1 < n) fetch_meta(it + 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    __nv_bfloat16* Ks = tiles + (b * 2) * BK * LD;
    __nv_bfloat16* Vs = Ks + BK * LD;
    const int* kq = kpos + (it & 1) * BK;
    auto visible = [&](int i, int j) {
      bool ok = kq[j] <= qp[i];
      if (window > 0) ok = ok && kq[j] > qp[i] - window;
      return ok;
    };
    if (it < n1) {
      // packed codes -> bf16 codes, each byte once per block
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int i = tid + u * NT;
        if (NCOPY % NT && i >= NCOPY) break;
        const int kv = i / (BK * CPR), j = (i / CPR) % BK, ch = i % CPR;
        const uint4 w = *reinterpret_cast<const uint4*>(
            packed + ((b * 2 + kv) * BK + j) * DC + ch * 16);
        __nv_bfloat16* dst = (kv ? Vs : Ks) + j * LD;
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        if constexpr (BITS == 4) {  // dims 16ch.. (low) and D/2 + 16ch.. (high)
          uint32_t lo8[8], hi8[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t a[2], bb[2];
            kv4_to_bf16(words[e], a, bb);
            lo8[2 * e] = a[0], lo8[2 * e + 1] = a[1];
            hi8[2 * e] = bb[0], hi8[2 * e + 1] = bb[1];
          }
          uint4* dl = reinterpret_cast<uint4*>(dst + 16 * ch);
          uint4* dh = reinterpret_cast<uint4*>(dst + D / 2 + 16 * ch);
          dl[0] = make_uint4(lo8[0], lo8[1], lo8[2], lo8[3]);
          dl[1] = make_uint4(lo8[4], lo8[5], lo8[6], lo8[7]);
          dh[0] = make_uint4(hi8[0], hi8[1], hi8[2], hi8[3]);
          dh[1] = make_uint4(hi8[4], hi8[5], hi8[6], hi8[7]);
        } else {  // dims 16ch .. 16ch + 15
          uint32_t x[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t a[2];
            kv8_to_bf16(words[e], a);
            x[2 * e] = a[0], x[2 * e + 1] = a[1];
          }
          uint4* d8 = reinterpret_cast<uint4*>(dst + 16 * ch);
          d8[0] = make_uint4(x[0], x[1], x[2], x[3]);
          d8[1] = make_uint4(x[4], x[5], x[6], x[7]);
        }
      }
      __syncthreads();
      const float4* mt = meta + (it & 1) * BK;
      auto weight = [&](float p, int i, int j) {
        z[i] = fmaf(p, mt[j].w, z[i]);
        return p * mt[j].z;
      };
      // a tile every live row sees whole needs no mask (padding rows are
      // zeroed at the end)
      const int c0 = lo + it * BK;
      const bool full =
          c0 + BK <= hi && c0 + BK - 1 <= qmin && (window <= 0 || c0 > qmax - window);
      attend_tile<D>(
          qa, Ks, Vs,
          [&](float acc, int i, int j) {
            return full || visible(i, j) ? fmaf(acc, mt[j].x, mt[j].y * sqc[i]) : NEG_INF;
          },
          weight, m, l, z, o);
    } else {
      attend_tile<D>(
          qa, Ks, Vs,
          [&](float acc, int i, int j) { return visible(i, j) ? acc * c : NEG_INF; },
          [](float p, int, int) { return p; }, m, l, z, o);
    }
    if (it + 1 < n) put_meta(it + 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)  // rows of padding come out 0
    if (qp[i] < 0) {
      l[i] = z[i] = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) o[d][2 * i] = o[d][2 * i + 1] = 0.f;
    }
  store_rows<D>(o, l, z, orow);
}

template <int D, int BITS>
int launch(const void* q, const void* k, const void* v, const void* seg,
           const void* pos, const void* data, const void* scales,
           int scale_bf16, const void* table, void* out, int T, int Hq, int H,
           int ps, int prefix_len, float sm_scale, int window,
           cudaStream_t st) {
  constexpr int LD = D + 8, DC = D * BITS / 8;
  constexpr int smem = STAGES * 2 * BK * (LD * 2 + DC) + 2 * BK * (16 + 4);
  static bool attr = false;  // dynamic shared memory above 48 KB
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefix_prefill_kernel<D, BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int bq = 16 * WARPS / (Hq / H);
  const dim3 grid(H, (T + bq - 1) / bq);
  prefix_prefill_kernel<D, BITS><<<grid, NT, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (const int*)pos,
      (const int8_t*)data, scales, scale_bf16, (const int*)table,
      (__nv_bfloat16*)out, T, Hq, H, ps, prefix_len, sm_scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// data/scales are ONE layer of the cache ([P, 2, ps, H*Dc], [P, 2, 2H, ps]).
// 256 threads (8 warps) per block; the wrapper keeps Hq / H <= 8, D in
// {64, 96, 128, 256} (D = 256 holds 2x the registers of D = 128: ptxas
// reports its spill),
// kv_bits in {4, 8} and prefix_len <= maxP * ps.
extern "C" int qs_prefix_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg,
    const void* pos, const void* data, const void* scales, int scale_bf16,
    const void* table, void* out, int T, int Hq, int H, int D, int kv_bits,
    int ps, int prefix_len, float sm_scale, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define QS_LAUNCH(D_, BITS_)                                                  \
  return launch<D_, BITS_>(q, k, v, seg, pos, data, scales, scale_bf16,       \
                           table, out, T, Hq, H, ps, prefix_len, sm_scale,    \
                           window, st)
  if (D == 128 && kv_bits == 4) QS_LAUNCH(128, 4);
  if (D == 128 && kv_bits == 8) QS_LAUNCH(128, 8);
  if (D == 64 && kv_bits == 4) QS_LAUNCH(64, 4);
  if (D == 64 && kv_bits == 8) QS_LAUNCH(64, 8);
  if (D == 96 && kv_bits == 4) QS_LAUNCH(96, 4);
  if (D == 96 && kv_bits == 8) QS_LAUNCH(96, 8);
  if (D == 256 && kv_bits == 4) QS_LAUNCH(256, 4);
  if (D == 256 && kv_bits == 8) QS_LAUNCH(256, 8);
#undef QS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
