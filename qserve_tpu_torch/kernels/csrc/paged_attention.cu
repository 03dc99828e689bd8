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
// the port's plain version, up to the order of its f32 sums.
//
// What bounds it on an H100: the bytes of the paged history, (Dc + 2 scale
// values) per key per head for K and for V, read once from HBM (3.35 TB/s).
// The f32 arithmetic (4 * rep * D flops a key) is of the same order at
// rep 4-8 on the CUDA cores (67 TFLOP/s), so it is kept lean too.
//
// Design (flash-decoding): the history of each (sequence, kv head) is cut
// into nsplit ranges of 64-key chunks (the wrapper picks nsplit so that the
// grid B x H x nsplit fills the card; each block cuts its sequence's actual
// history evenly), one block of 128 threads a range. A block copies its
// slice of the block table into shared memory, then keeps two chunks in
// flight by cp.async in a ring of three: the K and V codes of 64 keys (16-byte
// granules) and, when the page size is a multiple of 64 (a chunk then lies
// in one page), the chunk's four scale/zero rows, 16 bytes at a time. Per
// chunk:
//   QK   NP threads share a key's row, each a part of its bytes, and each
//        thread takes 64 * NP / 128 keys: scores in the code domain,
//        q.k = sc (q.c) + zp sum(q), q in f32 from shared memory (broadcast),
//        the parts summed by warp shuffles;
//   softmax  one warp per query row (two at rep 8): max and sums by warp
//        shuffles; p * v_scale goes to shared memory, sum(p * v_zero) and l
//        stay in the warp's registers;
//   PV   a group of Dc/4 threads covers a row, one 32-bit word (8 KV4 or 4
//        KV8 values) each; groups take keys in turn, each thread keeping
//        rep x 8 (or 4) f32 sums of (p * v_scale) * code.
// At the end the groups' sums are added in a fixed order. With one split the
// block merges the current token and writes out; with several it writes
// (m, l, o) to scratch and a second kernel merges the splits and the current
// token. The query heads of a kv head (rep <= 8) share every staged chunk
// (GQA); the kernel is instantiated for REP = 1, 4, 8 rows (a rep below REP
// runs zero rows that are never stored).

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

constexpr int THREADS = 128;
constexpr int CK = 64;      // keys per chunk
// ring slots, two chunks in flight: a fourth slot measured no faster at KV4
// and 11-23% slower at KV8, where its shared memory costs a resident block
// (scripts/ab_decode_gemm.py)
constexpr int STAGES = 3;
constexpr int SCALE_BYTES = 4 * CK * 4;  // a chunk's 4 scale rows, f32 at most

// Shared-memory plan of one instance; offsets in bytes.
template <int D, int BITS, int REP>
struct Plan {
  static constexpr int DC = D * BITS / 8;  // bytes of one head's row
  // row stride: an odd number of 16-byte granules, so the 8 rows of a
  // 16-byte-per-lane phase fall on distinct bank groups
  static constexpr int LDK = (DC / 16) % 2 ? DC + 32 : DC + 16;
  static constexpr int CPR = DC / 16;      // 16-byte granules a row
  static constexpr int STAGE = 2 * CK * LDK + SCALE_BYTES;
  // QK: NP threads a key, PB bytes each
  static constexpr int NP = (DC / 8) % 4 == 0 ? 4 : 2;
  static constexpr int PB = DC / NP;
  static constexpr int KPT = CK * NP / THREADS;  // keys a thread
  // q rows in f32, 4 floats of pad after every PB dims (the NP parts of a
  // broadcast load then sit on distinct banks)
  static constexpr int QLD = D + 4 * (D / PB);
  // PV: NW threads (one 32-bit word each) a row, NG groups
  static constexpr int NW = DC / 4;
  static constexpr int NG = THREADS / NW;
  static constexpr int CPW = BITS == 4 ? 8 : 4;  // values a word
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PARTS = NG * REP * D * 4;  // per-group sums, at the end
  static constexpr int BIG = (RING > PARTS ? RING : PARTS);
  static constexpr int OQ = BIG;                          // q: REP x QLD f32
  static constexpr int OS = OQ + REP * QLD * 4;           // scores: REP x CK
  static constexpr int OP = OS + REP * CK * 4;            // p * vsc: CK x REP
  static constexpr int OO = OP + CK * REP * 4;            // out sums: REP x D
  static constexpr int OV = OO + REP * D * 4;             // 6 x REP row values
  static constexpr int OT = OV + 6 * REP * 4 + 32;        // block table slice
  static int bytes(int ntbl) { return OT + ntbl * 4; }
};

__device__ __forceinline__ float u8f(uint32_t w, int k) {
  // byte k of w as a float, exactly: 2^23 + byte minus 2^23
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + k)) - 8388608.f;
}

// the 8 (KV4) or 4 (KV8) codes of one 32-bit word of a cached row, as
// floats: KV4 low nibbles (dims b..b+3) then high (dims D/2 + b..)
template <int BITS>
__device__ __forceinline__ void word_codes(uint32_t w, float* c) {
  if constexpr (BITS == 4) {
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = u8f(lo, k), c[4 + k] = u8f(hi, k);
  } else {
    const uint32_t u = w ^ 0x80808080u;  // stored u - 128 -> code u
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = u8f(u, k);
  }
}

// Rows r < rep of kv head h of sequence b: merge ns partial softmax states
// (pm, pl [r * ns + s], po [(r * ns + s) * D + d]; o unnormalised) with the
// current token's exact K/V and write out. red: 8 floats of shared memory.
__device__ __forceinline__ void finish_rows(int b, int h, int rep, int Hq, int H, int D,
                            int ns, const float* pm, const float* pl,
                            const float* po,
                            const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_cur,
                            const __nv_bfloat16* __restrict__ v_cur,
                            __nv_bfloat16* __restrict__ out, float sm_scale,
                            float* red) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t cur = ((size_t)b * H + h) * D;
  for (int r = warp; r < rep; r += THREADS / 32) {
    const __nv_bfloat16* qr = q + ((size_t)b * Hq + h * rep + r) * D;
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part = fmaf(__bfloat162float(qr[d]), __bfloat162float(k_cur[cur + d]),
                  part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) red[r] = part * sm_scale;
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float sc = red[r];
    float mx = sc;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, pm[r * ns + s]);
    const float pc = __expf(sc - mx);
    float num = pc * __bfloat162float(v_cur[cur + d]), den = pc;
    for (int s = 0; s < ns; ++s) {
      const float w = __expf(pm[r * ns + s] - mx);
      num = fmaf(w, po[(size_t)(r * ns + s) * D + d], num);
      den = fmaf(w, pl[r * ns + s], den);
    }
    out[((size_t)b * Hq + h * rep + r) * D + d] = __float2bfloat16_rn(num / den);
  }
}

template <int D, int BITS, int REP>
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ data,
                    const void* __restrict__ scales, int scale_bf16,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens,
                    const __nv_bfloat16* __restrict__ k_cur,
                    const __nv_bfloat16* __restrict__ v_cur,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_o,
                    int Hq, int H, int ps, int maxP, int ntbl, float sm_scale,
                    int window) {
  using L = Plan<D, BITS, REP>;
  constexpr int DC = L::DC, LDK = L::LDK, CPR = L::CPR, NP = L::NP,
                PB = L::PB, KPT = L::KPT, QLD = L::QLD, NW = L::NW,
                NG = L::NG, CPW = L::CPW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::OQ);
  float* S = reinterpret_cast<float*>(smem + L::OS);
  float* Pm = reinterpret_cast<float*>(smem + L::OP);
  float* O = reinterpret_cast<float*>(smem + L::OO);
  float* alpha = reinterpret_cast<float*>(smem + L::OV);  // [REP]
  float* qsum = alpha + REP;
  float* mrow = qsum + REP;
  float* lrow = mrow + REP;
  float* zrow = lrow + REP;
  float* red = zrow + REP;  // 8 floats
  int* tbl = reinterpret_cast<int*>(smem + L::OT);

  const int h = blockIdx.y, b = blockIdx.z, split = blockIdx.x;
  const int ns = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rep = Hq / H;
  const size_t HDc = (size_t)H * DC;
  const int hist = max(context_lens[b] - 1, 0);
  const int kbeg = window > 0 ? max(0, hist - window + 1) : 0;
  // this split's chunks: the history from the chunk holding kbeg, cut
  // evenly into ns runs of whole chunks
  const int a0 = (kbeg / CK) * CK;
  const int nch = (hist - a0 + CK - 1) / CK;
  const int per = (nch + ns - 1) / ns;
  const int cs = a0 + split * per * CK;
  const int ce = min(hist, cs + per * CK);
  const int n = ce > cs ? (ce - cs + CK - 1) / CK : 0;
  const int p0 = cs / ps;
  const bool fast = ps % CK == 0;  // a chunk lies in one page
  const int esz = scale_bf16 ? 2 : 4;

  // q rows (zero past rep), the block-table slice
  for (int i = tid; i < REP * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * QLD + d + 4 * (d / PB)] =
        r < rep ? __bfloat162float(q[((size_t)b * Hq + h * rep + r) * D + d]) : 0.f;
  }
  if (n > 0) {
    const int np = min((ce - 1) / ps - p0 + 1, ntbl);
    const int* table = block_tables + (size_t)b * maxP;
    for (int i = tid; i < np; i += THREADS) tbl[i] = table[p0 + i];
  }
  __syncthreads();
  for (int r = warp; r < REP; r += THREADS / 32) {
    float sm = 0.f;
    for (int d = lane; d < D; d += 32) sm += qs[r * QLD + d + 4 * (d / PB)];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
    if (lane == 0) qsum[r] = sm;
  }
  float m_w[2] = {NEG_INF, NEG_INF}, l_w[2] = {0.f, 0.f}, z_w[2] = {0.f, 0.f};

  auto stage_of = [&](int it) { return smem + (it % STAGES) * L::STAGE; };
  auto issue = [&](int it) {
    unsigned char* st = stage_of(it);
    const int c0 = cs + it * CK;
    const int pg0 = tbl[c0 / ps - p0];
#pragma unroll
    for (int u = 0; u < 2 * CK * CPR / THREADS; ++u) {
      const int i = tid + u * THREADS;
      const int kv = i / (CK * CPR), j = (i / CPR) % CK, ch = i % CPR;
      const int s = c0 + j;
      const bool ok = s >= kbeg && s < ce;
      const int page = fast ? pg0 : (ok ? tbl[s / ps - p0] : 0);
      const int slot = s % ps;
      const int8_t* src =
          data + (((size_t)page * 2 + kv) * ps + slot) * HDc + h * DC + ch * 16;
      cp_async16(st + kv * CK * LDK + j * LDK + ch * 16, ok ? src : data, ok);
    }
    if (fast) {
      const int gpr = CK * esz / 16;  // granules a scale row
      if (tid < 4 * gpr) {
        const int e = tid / gpr, gi = tid % gpr;
        const size_t idx =
            (((size_t)pg0 * 2 + (e >> 1)) * 2 * H + (e & 1) * H + h) * ps + c0 % ps;
        cp_async16(st + 2 * CK * LDK + e * CK * esz + gi * 16,
                   (const unsigned char*)scales + idx * esz + gi * 16, true);
      }
    }
  };
  // scale (e = 0 k scale, 1 k zero, 2 v scale, 3 v zero) of key j of chunk
  // (0 outside the split's keys: a stale slot may hold any bits)
  auto scale_of = [&](const unsigned char* st, int c0, int e, int j) -> float {
    const int s = c0 + j;
    if (s < kbeg || s >= ce) return 0.f;
    if (fast) {
      const unsigned char* p = st + 2 * CK * LDK + (e * CK + j) * esz;
      return scale_bf16 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p))
                        : *reinterpret_cast<const float*>(p);
    }
    const int page = tbl[s / ps - p0];
    return load_scale(scales, scale_bf16,
                      (((size_t)page * 2 + (e >> 1)) * 2 * H + (e & 1) * H + h) * ps +
                          s % ps);
  };

  float acc[REP][CPW];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int c = 0; c < CPW; ++c) acc[r][c] = 0.f;
  const int pg = tid / NW, pw = tid % NW;  // PV group and word
  const bool pv_on = pg < NG;
  const int qp = tid % NP, qk = tid / NP;  // QK part and first key

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < n) issue(it);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (it + STAGES - 1 < n) issue(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* st = stage_of(it);
    const int c0 = cs + it * CK;

    // QK: this thread's part of keys qk + k * THREADS / NP
    {
      float dot[KPT][REP];
#pragma unroll
      for (int k = 0; k < KPT; ++k)
#pragma unroll
        for (int r = 0; r < REP; ++r) dot[k][r] = 0.f;
#pragma unroll
      for (int u = 0; u < PB / 8; ++u) {
        const int byte0 = qp * PB + u * 8;
        float c[KPT][16];
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          const int j = qk + k * (THREADS / NP);
          const uint2 w = *reinterpret_cast<const uint2*>(st + j * LDK + byte0);
          word_codes<BITS>(w.x, c[k]);
          word_codes<BITS>(w.y, c[k] + CPW);
        }
        // dims of c[k][e]: KV4 byte0 + {0..3, D/2.., 4..7, D/2 + 4..}; KV8
        // byte0 + e. qi: the padded q index of a dim.
        auto qi = [](int d) { return d + 4 * (d / PB); };
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float* qr = qs + r * QLD;
          if constexpr (BITS == 4) {
            const float4 a = *reinterpret_cast<const float4*>(qr + qi(byte0));
            const float4 a2 = *reinterpret_cast<const float4*>(qr + qi(byte0) + 4);
            const float4 bh = *reinterpret_cast<const float4*>(qr + qi(D / 2 + byte0));
            const float4 b2 = *reinterpret_cast<const float4*>(qr + qi(D / 2 + byte0) + 4);
            const float qv[16] = {a.x,  a.y,  a.z,  a.w,  bh.x, bh.y, bh.z, bh.w,
                                  a2.x, a2.y, a2.z, a2.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
            for (int k = 0; k < KPT; ++k)
#pragma unroll
              for (int e = 0; e < 16; ++e) dot[k][r] = fmaf(qv[e], c[k][e], dot[k][r]);
          } else {
            const float4 a = *reinterpret_cast<const float4*>(qr + qi(byte0));
            const float4 a2 = *reinterpret_cast<const float4*>(qr + qi(byte0) + 4);
            const float qv[8] = {a.x, a.y, a.z, a.w, a2.x, a2.y, a2.z, a2.w};
#pragma unroll
            for (int k = 0; k < KPT; ++k)
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[k][r] = fmaf(qv[e], c[k][e], dot[k][r]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int j = qk + k * (THREADS / NP), s = c0 + j;
        const bool ok = s >= kbeg && s < ce;
        const float ksc = scale_of(st, c0, 0, j), kzp = scale_of(st, c0, 1, j);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
#pragma unroll
          for (int o = 1; o < NP; o <<= 1)
            dot[k][r] += __shfl_xor_sync(0xffffffffu, dot[k][r], o);
          if (r % NP == qp)
            S[r * CK + j] = ok ? sm_scale * fmaf(ksc, dot[k][r], kzp * qsum[r]) : NEG_INF;
        }
      }
    }
    __syncthreads();

    // softmax: warp w owns rows w and w + 4
#pragma unroll
    for (int i = 0; i < (REP + 3) / 4; ++i) {
      const int r = warp + 4 * i;
      if (r < REP) {
        const float s0 = S[r * CK + lane], s1 = S[r * CK + lane + 32];
        float mc = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
        const float mn = fmaxf(m_w[i], mc);
        const float al = __expf(m_w[i] - mn);
        const float e0 = s0 > 0.5f * NEG_INF ? __expf(s0 - mn) : 0.f;
        const float e1 = s1 > 0.5f * NEG_INF ? __expf(s1 - mn) : 0.f;
        float ps_ = e0 + e1;
        float zs = e0 * scale_of(st, c0, 3, lane) + e1 * scale_of(st, c0, 3, lane + 32);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ps_ += __shfl_xor_sync(0xffffffffu, ps_, o);
          zs += __shfl_xor_sync(0xffffffffu, zs, o);
        }
        m_w[i] = mn;
        l_w[i] = fmaf(l_w[i], al, ps_);
        z_w[i] = fmaf(z_w[i], al, zs);
        Pm[lane * REP + r] = e0 * scale_of(st, c0, 2, lane);
        Pm[(lane + 32) * REP + r] = e1 * scale_of(st, c0, 2, lane + 32);
        if (lane == 0) alpha[r] = al;
      }
    }
    __syncthreads();

    // PV: group pg takes keys pg, pg + NG, ...; word pw of each V row
    if (pv_on) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float al = alpha[r];
#pragma unroll
        for (int c = 0; c < CPW; ++c) acc[r][c] *= al;
      }
      const unsigned char* V = st + CK * LDK;
      for (int j = pg; j < CK; j += NG) {
        float c[CPW];
        word_codes<BITS>(*reinterpret_cast<const uint32_t*>(V + j * LDK + 4 * pw), c);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = Pm[j * REP + r];
#pragma unroll
          for (int e = 0; e < CPW; ++e) acc[r][e] = fmaf(p, c[e], acc[r][e]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the groups' sums, added in group order, plus the zero term
  float* parts = reinterpret_cast<float*>(smem);  // [NG][REP][D], over the ring
  if (pv_on) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < CPW; ++e) {
        const int d = BITS == 4 ? (e < 4 ? 4 * pw + e : D / 2 + 4 * pw + e - 4) : 4 * pw + e;
        parts[(pg * REP + r) * D + d] = acc[r][e];
      }
  }
#pragma unroll
  for (int i = 0; i < (REP + 3) / 4; ++i) {
    const int r = warp + 4 * i;
    if (r < REP && lane == 0) mrow[r] = m_w[i], lrow[r] = l_w[i], zrow[r] = z_w[i];
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float o = zrow[r];
    for (int g = 0; g < NG; ++g) o += parts[(g * REP + r) * D + d];
    O[r * D + d] = o;
  }
  __syncthreads();
  if (ns == 1) {
    finish_rows(b, h, rep, Hq, H, D, 1, mrow, lrow, O, q, k_cur, v_cur, out,
                sm_scale, red);
    return;
  }
  const size_t row0 = (size_t)b * Hq + h * rep;  // [B, Hq, ns(, D)]
  for (int i = tid; i < rep * D; i += THREADS) {
    const int r = i / D, d = i % D;
    part_o[((row0 + r) * ns + split) * D + d] = O[r * D + d];
  }
  if (tid < rep) {
    part_m[(row0 + tid) * ns + split] = mrow[tid];
    part_l[(row0 + tid) * ns + split] = lrow[tid];
  }
}

// Merge the ns splits of each (sequence, kv head) with the current token.
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_merge_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_o,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_cur,
                          const __nv_bfloat16* __restrict__ v_cur,
                          __nv_bfloat16* __restrict__ out, int Hq, int H, int D,
                          int ns, float sm_scale) {
  __shared__ float red[8];
  const int h = blockIdx.x, b = blockIdx.y, rep = Hq / H;
  const size_t row0 = (size_t)b * Hq + h * rep;
  finish_rows(b, h, rep, Hq, H, D, ns, part_m + row0 * ns, part_l + row0 * ns,
              part_o + row0 * ns * D, q, k_cur, v_cur, out, sm_scale, red);
}

template <int D, int BITS, int REP>
int launch(const void* q, const void* data, const void* scales, int scale_bf16,
           const void* block_tables, const void* context_lens,
           const void* k_cur, const void* v_cur, void* out, void* part_m,
           void* part_l, void* part_o, int B, int Hq, int H, int ps, int maxP,
           int nsplit, float sm_scale, int window, cudaStream_t st) {
  using L = Plan<D, BITS, REP>;
  // pages of one split: its keys (whole chunks) may touch one page more
  const int per = ((maxP * ps + CK - 1) / CK + nsplit - 1) / nsplit;
  const int span = (per * CK + ps - 1) / ps + 1;
  const int ntbl = span < maxP ? span : maxP;
  const int smem = L::bytes(ntbl);
  static int attr = 0;  // dynamic shared memory granted so far
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<D, BITS, REP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  paged_decode_kernel<D, BITS, REP><<<dim3(nsplit, H, B), THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const int8_t*)data, scales, scale_bf16,
      (const int*)block_tables, (const int*)context_lens,
      (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
      (__nv_bfloat16*)out, (float*)part_m, (float*)part_l, (float*)part_o, Hq,
      H, ps, maxP, ntbl, sm_scale, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  paged_decode_merge_kernel<<<dim3(H, B), THREADS, 0, st>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_o,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur,
      (const __nv_bfloat16*)v_cur, (__nv_bfloat16*)out, Hq, H, D, nsplit,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// data/scales are ONE layer of the cache ([P, 2, ps, H*Dc], [P, 2, 2H, ps]).
// part_m/part_l [B, Hq, nsplit] and part_o [B, Hq, nsplit, D] f32 are
// scratch (unused when nsplit == 1). The wrapper keeps rep <= 8,
// D in {64, 96, 128, 256}, kv_bits in {4, 8} and 1 <= nsplit.
extern "C" int qs_paged_decode_attention(
    const void* q, const void* data, const void* scales, int scale_bf16,
    const void* block_tables, const void* context_lens, const void* k_cur,
    const void* v_cur, void* out, void* part_m, void* part_l, void* part_o,
    int B, int Hq, int H, int D, int kv_bits, int ps, int maxP, int nsplit,
    float sm_scale, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rep = Hq / H;
#define QS_LAUNCH(D_, BITS_, REP_)                                            \
  return launch<D_, BITS_, REP_>(q, data, scales, scale_bf16, block_tables,   \
                                 context_lens, k_cur, v_cur, out, part_m,     \
                                 part_l, part_o, B, Hq, H, ps, maxP, nsplit,  \
                                 sm_scale, window, st)
#define QS_REPS(D_, BITS_)                   \
  if (D == D_ && kv_bits == BITS_) {         \
    if (rep == 1) QS_LAUNCH(D_, BITS_, 1);   \
    if (rep <= 4) QS_LAUNCH(D_, BITS_, 4);   \
    QS_LAUNCH(D_, BITS_, 8);                 \
  }
  QS_REPS(128, 4)
  QS_REPS(128, 8)
  QS_REPS(64, 4)
  QS_REPS(64, 8)
  if (D == 96 && kv_bits == 4) QS_LAUNCH(96, 4, 8);
  if (D == 96 && kv_bits == 8) QS_LAUNCH(96, 8, 8);
  if (D == 256 && kv_bits == 4) QS_LAUNCH(256, 4, 8);
  if (D == 256 && kv_bits == 8) QS_LAUNCH(256, 8, 8);
#undef QS_REPS
#undef QS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
