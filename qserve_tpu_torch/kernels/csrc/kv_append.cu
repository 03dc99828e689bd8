// K5: quantize every layer's new K/V and append it to the paged cache, in
// one launch.
//
// Replaces: qserve_tpu/kernels/pallas_kv_append.py kv_append_inplace (the
// decode append) and kv_write_pages_inplace (the prefill page write), with
// the quantization that ran before them in XLA
// (qserve_tpu/kernels/kv_cache.py _quantize_rows, the staging and page
// dedup of append_all_layers). QServe's own CUDA engine fuses the two the
// same way (applyBiasRopeUpdateKVCache.h).
//
// k, v bf16 [L, T, H, D] (any layer and token strides; heads and dims
// dense), page_ids/slots int32 [T] -> in place, for every token whose page
// is not -1, each (layer, token, kv, head) vector of D values quantized per
// token and per head:
//   asymmetric (zero point): scale = max(mx - mn, 1e-8) / qmax, zero = mn,
//     q = clamp(rint((x - mn) / scale), 0, qmax);
//   symmetric: scale = max(amax |x|, 1e-8) / (qmax / 2), zero = -2^(b-1) *
//     scale, q = clamp(rint(x / scale), -qmax/2 - 1, qmax/2) + 2^(b-1);
// qmax = 2^b - 1 (b = 4 or 8). Division is IEEE (__fdiv_rn; the build uses
// no fast math; (x - lo) / scale as a product with the reciprocal, the IEEE
// quotient taken where the two could round apart) and rintf rounds half to
// even, so the codes equal
// kernels/kv_cache.py's plain chain (quant/qoq.py quantize_kv) bit for bit;
// min and max are exact in any order. The packed row goes to data[l, page,
// kv, slot, h*Dc : (h+1)*Dc] (KV4: byte j holds dims j and j + D/2 as its
// low and high nibble, Dc = D/2; KV8: u - 128, Dc = D), scale and zero to
// scales[l, page, kv, h, slot] and [.., H + h, slot], rounded to the cache's
// bf16 (RNE) or kept f32; the codes use the f32 scale. Two valid tokens
// never share a (page, slot), except on pages a prefix shares within one
// batch: those receive identical bytes.
//
// What bounds it on an H100: bytes. The bf16 K/V of the valid tokens are
// read once and the packed rows and scales written once (3.35 TB/s); the
// arithmetic is ~6 f32 operations a value.
//
// Design: a block takes `tb` consecutive tokens of one layer (the host
// picks tb: 16 where the grid still fills the card, else at most 64 vectors
// a block). Its vectors are processed by groups of G lanes (G = 8, 16 or 32,
// the power of two at or above D / 8), each lane holding 8 values from one
// 16-byte load; a warp holds 32 / G vectors at once, and the block's warps
// take side-by-side vectors in each of U rounds, whose loads all issue
// before any computes, to keep bytes in flight (a decode block keeps all
// its warps busy in round 0). A lane reduces its 8 values to one bf16 pair,
// (max, -min) (exact: they are bf16 values), and the group reduces the
// pairs by one shuffle and one bf16x2 max a level. (x - lo) / scale is a
// product with the reciprocal (~16% less device time than the IEEE
// quotient of every value). The KV4 partner dims j + D/2 sit D/16 lanes
// away (one shuffle of two code words), so each lane of the low half stores
// 8 packed bytes and a head's Dc bytes go out as one coalesced run of the
// token's contiguous row. Scale and zero are staged in shared memory as
// [kv][2H][token] and written by consecutive threads over consecutive
// tokens: where the block's tokens fill consecutive slots of one page
// (every prefill and chunk) each of the 2 x 2H scale rows is one contiguous
// run; a decode token owns its page and keeps single stores. A head dim
// that is not a multiple of 8 (16 for KV4) or an operand not 16-byte
// aligned takes the scalar path: a warp a vector, dims lane + 32 i, f32
// min/max, the codes packed through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 2;  // rounds of loads a warp issues before it computes
constexpr int MAX_D = 256;
constexpr int SCALAR_VALS = MAX_D / 32;  // values a lane on the scalar path

struct Args {
  const uint16_t* k;  // bf16 bits
  const uint16_t* v;
  long long k_sl, k_st, v_sl, v_st;  // layer and token strides, elements
  int8_t* data;                      // [L, P, 2, ps, H * Dc]
  uint8_t* scales;                   // [L, P, 2, 2H, ps], 2- or 4-byte
  const int* page_ids;
  const int* slots;
  int T, P, ps, H, D, bits, zero_point, scale_bytes, tb;
};

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) {
  return __uint_as_float(b << 16);
}

// one vector's reductions: (mx, mn) or, symmetric, (amax, -)
struct Stats {
  float a, b;
};

// the scalar path's: f32 over a warp
__device__ __forceinline__ Stats reduce(Stats s, bool zero_point) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.a = fmaxf(s.a, __shfl_xor_sync(0xffffffffu, s.a, off));
    if (zero_point) s.b = fminf(s.b, __shfl_xor_sync(0xffffffffu, s.b, off));
  }
  return s;
}

__device__ __forceinline__ void accumulate(Stats& s, float x, bool zero_point) {
  if (zero_point) {
    s.a = fmaxf(s.a, x);
    s.b = fminf(s.b, x);
  } else {
    s.a = fmaxf(s.a, fabsf(x));
  }
}

__device__ __forceinline__ Stats identity(bool zero_point) {
  return zero_point ? Stats{-INFINITY, INFINITY} : Stats{0.f, 0.f};
}

// A lane's 8 values (4 words of 2 bf16) reduced to one bf16 pair: (max,
// -min) with a zero point, (max |x|, max |x|) without; exact, since they
// are bf16 values. Lanes without values hold the identity.
__device__ __forceinline__ uint32_t lane_pair(const uint32_t w[4], bool live,
                                              bool zero_point) {
  auto mx = [](uint32_t a, uint32_t b) {
    const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
  };
  if (!live) return zero_point ? 0xFF80FF80u : 0u;  // (-inf, -inf) or (0, 0)
  if (zero_point) {
    const uint32_t a = mx(mx(w[0], w[1]), mx(w[2], w[3]));  // max even, odd
    const uint32_t n = mx(mx(w[0] ^ 0x80008000u, w[1] ^ 0x80008000u),
                          mx(w[2] ^ 0x80008000u, w[3] ^ 0x80008000u));
    return mx(__byte_perm(a, n, 0x5410), __byte_perm(a, n, 0x7632));
  }
  const uint32_t a = mx(mx(w[0] & 0x7FFF7FFFu, w[1] & 0x7FFF7FFFu),
                        mx(w[2] & 0x7FFF7FFFu, w[3] & 0x7FFF7FFFu));
  return mx(a, __byte_perm(a, a, 0x1032));
}

template <int WIDTH>
__device__ __forceinline__ Stats reduce_pair(uint32_t p) {
#pragma unroll
  for (int off = WIDTH / 2; off > 0; off >>= 1) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, p, off, WIDTH);
    const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                     *reinterpret_cast<const __nv_bfloat162*>(&o));
    p = *reinterpret_cast<const uint32_t*>(&r);
  }
  return Stats{bf16_bits_to_float(p & 0xFFFFu), -bf16_bits_to_float(p >> 16)};
}

// the vector's quantizer from its reduced stats
struct Quant {
  float scale, inv, zero, lo;  // inv: the IEEE reciprocal; lo: mn or 0
  float qmin, qmax, offset;
};

__device__ __forceinline__ Quant make_quant(Stats s, int bits, bool zero_point) {
  const int qmax = (1 << bits) - 1;
  Quant q;
  if (zero_point) {
    q.scale = __fdiv_rn(fmaxf(__fsub_rn(s.a, s.b), 1e-8f), (float)qmax);
    q.zero = s.b;
    q.lo = s.b;
    q.qmin = 0.f;
    q.qmax = (float)qmax;
    q.offset = 0.f;
  } else {
    const int half = qmax / 2;
    q.scale = __fdiv_rn(fmaxf(s.a, 1e-8f), (float)half);
    q.zero = __fmul_rn(-(float)(1 << (bits - 1)), q.scale);
    q.lo = 0.f;
    q.qmin = (float)(-half - 1);
    q.qmax = (float)half;
    q.offset = (float)(1 << (bits - 1));
  }
  q.inv = __frcp_rn(q.scale);
  return q;
}

// the stored code, 0 .. 2^bits - 1: rint of the IEEE quotient (x - lo) /
// scale. The quotient is at most ~2^8, so its product with the reciprocal
// lies within 2^-23 of it relatively (3.1e-5): rint of the product is the
// same integer unless the product is within 1e-4 of a half-way point, where
// the IEEE quotient is taken instead.
__device__ __forceinline__ uint32_t code(const Quant& q, float x) {
  const float d = __fsub_rn(x, q.lo);
  const float p = __fmul_rn(d, q.inv);
  float r = rintf(p);
  if (fabsf(p - r) > 0.4999f) r = rintf(__fdiv_rn(d, q.scale));
  return (uint32_t)(int)(fminf(fmaxf(r, q.qmin), q.qmax) + q.offset);
}

__device__ __forceinline__ uint32_t scale_bits(float s, int scale_bytes) {
  return scale_bytes == 2 ? (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(s))
                          : __float_as_uint(s);
}

struct Smem {
  int* page;        // [tb]
  int* slot;        // [tb]
  uint32_t* sc;     // [2][2H][tb] scale / zero bits
  uint8_t* codes;   // scalar path: [WARPS][MAX_D]
};

__device__ __forceinline__ Smem carve(const Args& a, unsigned char* raw) {
  Smem s;
  s.page = reinterpret_cast<int*>(raw);
  s.slot = s.page + a.tb;
  s.sc = reinterpret_cast<uint32_t*>(s.slot + a.tb);
  s.codes = reinterpret_cast<uint8_t*>(s.sc + 2 * 2 * a.H * a.tb);
  return s;
}

// vector vi of the block: token tok, kv, head h (vectors of one token and
// kv run over the heads: contiguous in k/v and in the data row)
struct Vec {
  int tok, kv, h;
  bool ok;  // a token of this launch whose page is not -1
};

__device__ __forceinline__ Vec vector_at(const Args& a, const Smem& s, int vi,
                                         int nvec) {
  Vec r;
  r.h = vi % a.H;
  r.kv = (vi / a.H) & 1;
  r.tok = vi / (2 * a.H);
  r.ok = vi < nvec && s.page[min(r.tok, a.tb - 1)] >= 0;
  return r;
}

__device__ __forceinline__ const uint16_t* src_of(const Args& a, int l, int t,
                                                  const Vec& w) {
  return w.kv ? a.v + l * a.v_sl + t * a.v_st + (long long)w.h * a.D
              : a.k + l * a.k_sl + t * a.k_st + (long long)w.h * a.D;
}

__device__ __forceinline__ int8_t* row_of(const Args& a, const Smem& s, int l,
                                          const Vec& w, int dc) {
  const size_t row = (((size_t)l * a.P + s.page[w.tok]) * 2 + w.kv) * a.ps +
                     s.slot[w.tok];
  return a.data + row * a.H * dc + (size_t)w.h * dc;
}

__device__ __forceinline__ void stage(const Args& a, const Smem& s,
                                      const Vec& w, const Quant& q) {
  const int H2 = 2 * a.H;
  s.sc[(w.kv * H2 + w.h) * a.tb + w.tok] = scale_bits(q.scale, a.scale_bytes);
  s.sc[(w.kv * H2 + a.H + w.h) * a.tb + w.tok] = scale_bits(q.zero, a.scale_bytes);
}

// G lanes a vector, 8 values a lane from one 16-byte load
template <int G>
__device__ __forceinline__ void vector_path(const Args& a, const Smem& s, int l,
                                            int t0, int nvec) {
  constexpr int GPW = 32 / G;  // vectors a warp holds at once
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / G, li = lane % G;
  const int dv = a.D / 8;      // lanes holding values
  const int dc = a.bits == 4 ? a.D / 2 : a.D;
  const bool zp = a.zero_point != 0;
  for (int base = 0; base < nvec; base += WARPS * GPW * U) {
    uint4 raw[U];
    Vec w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // round u: the block's warps side by side
      w[u] = vector_at(a, s, base + (u * WARPS + warp) * GPW + grp, nvec);
      raw[u] = make_uint4(0, 0, 0, 0);
      if (w[u].ok && li < dv)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            src_of(a, l, t0 + w[u].tok, w[u]) + 8 * li));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!__any_sync(0xffffffffu, w[u].ok)) continue;  // warp-uniform
      const uint32_t words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      float x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = bf16_bits_to_float(words[i] & 0xFFFFu);
        x[2 * i + 1] = bf16_bits_to_float(words[i] >> 16);
      }
      const Stats st = reduce_pair<G>(lane_pair(words, li < dv, zp));
      const Quant q = make_quant(st, a.bits, zp);
      uint32_t c[2] = {0, 0};  // codes as bytes, dims 8 li .. 8 li + 7
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i / 4] |= code(q, x[i]) << (8 * (i % 4));
      uint2 out;
      bool store;
      if (a.bits == 4) {  // the high nibbles: dims + D/2, D/16 lanes on
        const int partner = li + a.D / 16;
        const uint32_t h0 = __shfl_sync(0xffffffffu, c[0], partner, G);
        const uint32_t h1 = __shfl_sync(0xffffffffu, c[1], partner, G);
        out = make_uint2(c[0] | (h0 << 4), c[1] | (h1 << 4));
        store = li < a.D / 16;
      } else {
        out = make_uint2(c[0] ^ 0x80808080u, c[1] ^ 0x80808080u);
        store = li < dv;
      }
      if (!w[u].ok) continue;
      if (store)
        *reinterpret_cast<uint2*>(row_of(a, s, l, w[u], dc) + 8 * li) = out;
      if (li == 0) stage(a, s, w[u], q);
    }
  }
}

// a warp a vector, dims lane + 32 i, scalar loads, codes packed through
// shared memory
__device__ __forceinline__ void scalar_path(const Args& a, const Smem& s,
                                            int l, int t0, int nvec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dc = a.bits == 4 ? a.D / 2 : a.D;
  const bool zp = a.zero_point != 0;
  uint8_t* codes = s.codes + warp * MAX_D;
  for (int vi = warp; vi < nvec; vi += WARPS) {
    const Vec w = vector_at(a, s, vi, nvec);  // uniform across the warp
    if (!w.ok) continue;
    const uint16_t* src = src_of(a, l, t0 + w.tok, w);
    float x[SCALAR_VALS];
    Stats st = identity(zp);
#pragma unroll
    for (int i = 0; i < SCALAR_VALS; ++i) {
      const int d = lane + 32 * i;
      x[i] = d < a.D ? bf16_bits_to_float(src[d]) : 0.f;
      if (d < a.D) accumulate(st, x[i], zp);
    }
    st = reduce(st, zp);
    const Quant q = make_quant(st, a.bits, zp);
#pragma unroll
    for (int i = 0; i < SCALAR_VALS; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) codes[d] = (uint8_t)code(q, x[i]);
    }
    __syncwarp();
    int8_t* dst = row_of(a, s, l, w, dc);
    for (int j = lane; j < dc; j += 32)
      dst[j] = (int8_t)(a.bits == 4 ? codes[j] | (codes[j + a.D / 2] << 4)
                                    : codes[j] ^ 0x80);
    if (lane == 0) stage(a, s, w, q);
    __syncwarp();
  }
}

template <int G>  // 0: the scalar path
__global__ void __launch_bounds__(THREADS) kv_quant_append_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(a, smem_raw);
  const int l = blockIdx.y, t0 = blockIdx.x * a.tb;
  for (int i = threadIdx.x; i < a.tb; i += THREADS) {
    const int t = t0 + i;
    s.page[i] = t < a.T ? a.page_ids[t] : -1;
    s.slot[i] = t < a.T ? a.slots[t] : 0;
  }
  __syncthreads();
  const int nvec = min(a.tb, a.T - t0) * 2 * a.H;
  if constexpr (G == 0)
    scalar_path(a, s, l, t0, nvec);
  else
    vector_path<G>(a, s, l, t0, nvec);
  __syncthreads();
  // scales: consecutive threads take consecutive tokens of one scale row
  const int H2 = 2 * a.H;
  for (int i = threadIdx.x; i < 2 * H2 * a.tb; i += THREADS) {
    const int tok = i % a.tb, row = i / a.tb;  // row = kv * 2H + j
    const int page = s.page[tok];
    if (page < 0) continue;
    const size_t dst = ((((size_t)l * a.P + page) * 2) * H2 + row) * a.ps + s.slot[tok];
    if (a.scale_bytes == 2)
      reinterpret_cast<uint16_t*>(a.scales)[dst] = (uint16_t)s.sc[i];
    else
      reinterpret_cast<uint32_t*>(a.scales)[dst] = s.sc[i];
  }
}

// shared memory a block needs, bytes (kernels/kv_append.py smem_bytes)
int smem_bytes(int H, int tb) { return tb * 2 * 4 + 2 * 2 * H * tb * 4 + WARPS * MAX_D; }

}  // namespace

// k, v: bf16 [L, T, H, D] at element strides (k_sl, k_st), (v_sl, v_st);
// data int8 [L, P, 2, ps, H * Dc], scales [L, P, 2, 2H, ps] (2- or 4-byte
// elements); page_ids, slots int32 [T]. lanes: 8, 16 or 32 lanes a vector
// with 16-byte loads, or 0 for the scalar path; tb tokens a block.
extern "C" int qs_kv_quant_append(const void* k, const void* v, long long k_sl,
                                  long long k_st, long long v_sl, long long v_st,
                                  void* data, void* scales, const void* page_ids,
                                  const void* slots, int L, int T, int P, int ps,
                                  int H, int D, int bits, int zero_point,
                                  int scale_bytes, int lanes, int tb,
                                  void* stream) {
  if (T == 0 || L == 0) return 0;
  Args a{(const uint16_t*)k, (const uint16_t*)v, k_sl, k_st, v_sl, v_st,
         (int8_t*)data, (uint8_t*)scales, (const int*)page_ids,
         (const int*)slots, T, P, ps, H, D, bits, zero_point, scale_bytes, tb};
  const dim3 grid((T + tb - 1) / tb, L);
  const int smem = smem_bytes(H, tb);
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 0: kv_quant_append_kernel<0><<<grid, THREADS, smem, st>>>(a); break;
    case 8: kv_quant_append_kernel<8><<<grid, THREADS, smem, st>>>(a); break;
    case 16: kv_quant_append_kernel<16><<<grid, THREADS, smem, st>>>(a); break;
    case 32: kv_quant_append_kernel<32><<<grid, THREADS, smem, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
