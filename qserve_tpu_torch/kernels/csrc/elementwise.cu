// K1: the fused elementwise / per-token INT8 quant pass, for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_elementwise.py _quant_jit (mode 0),
// _rmsnorm_quant_jit (1), _add_rmsnorm_quant_jit (2), _silu_mul_quant_jit
// (3).
//
// One token row of width W (the quantized width) per block:
//   mode 0: y = x                          x [T, W] bf16
//   mode 1: y = rmsnorm(x) * w             w [W] f32
//   mode 2: h = bf16(x + d), stored; y = rmsnorm(h) * w (the ROUNDED sum)
//   mode 3: y = silu(g) * u                x = [g | u], [T, 2W]
// then scale = max(amax |y|, 1e-8) / 127, q = clamp(rint(y / scale), -128,
// 127) (rint rounds half to even), act-sum = scale * sum(q). Division and
// square root are IEEE (__fdiv_rn, __fsqrt_rn; y / scale as a product with
// the reciprocal, the IEEE quotient taken where the two could round apart),
// so mode 0's codes equal quant/qoq.py's bit for bit; the norm's sum of
// squares is taken in another order than PyTorch's, which may move a code by
// one.
//
// What bounds it on an H100: the bytes of the pass (each input read once,
// q, h, scale and act-sum written once) at 3.35 TB/s.
//
// Design: the row lives in registers (modes 0-2 as the loaded bf16, 4
// registers a vector; mode 3 as the f32 y, 8). Vector j (8 columns, one
// 16-byte bf16 load) of pass-chunk c belongs to thread j % threads at slot
// (j / threads) % VPT: for each slot a warp reads 512 contiguous bytes.
// The host (kernels/elementwise.py launch_shape) picks the threads a row
// (a multiple of 32, at most 1024) and the vectors a thread (VPT, 1-8; 1-4
// in mode 3, whose f32 row would not fit 64 registers a thread) so the last
// round of vectors is as full as it can be: no power-of-two pad. A row
// wider than 1024 x VPT vectors (65536 columns, 32768 in mode 3) takes
// several chunks and is re-read from L2 in each of its passes. A width
// that is not a multiple of 8, or an operand not 16-byte aligned, takes
// scalar loads; the last vector is then a tail of W % 8 columns. The row
// reductions (sum of squares, amax, sum of codes) go through warp shuffles
// and one shared array, summed in warp order: a fixed order, so a row
// repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;  // 64 registers a thread
constexpr int MAX_VPT_F32 = 4;  // mode 3 holds 8 f32 a vector: 4 fit them
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int VEC = 8;  // columns a vector: 16 bytes of bf16

enum { QUANT = 0, RMSNORM = 1, ADD_RMSNORM = 2, SILU_MUL = 3 };

struct Row {
  const __nv_bfloat16* x;  // [W] (mode 3: g, u at + W)
  const __nv_bfloat16* d;  // mode 2
  const float* w;          // modes 1, 2
  __nv_bfloat16* h;        // mode 2
  int8_t* q;
  int W, nv;
  bool vec;  // 16-byte loads and 8-byte code stores
};

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 8 bf16 columns of a row from column c0, as loaded; columns past W read 0
__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* p, int c0,
                                          int W, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + c0));
  const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c0 + 2 * i < W ? ps[c0 + 2 * i] : 0u;
    const uint32_t hi = c0 + 2 * i + 1 < W ? ps[c0 + 2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16(a + b) column by column (round to nearest even), packed as loaded
__device__ __forceinline__ uint4 add_round(uint4 a, uint4 b) {
  float fa[VEC], fb[VEC];
  unpack8(a, fa);
  unpack8(b, fb);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(
               __float2bfloat16_rn(__fadd_rn(fa[2 * i], fb[2 * i]))) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(
                __fadd_rn(fa[2 * i + 1], fb[2 * i + 1])))
            << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_raw(__nv_bfloat16* p, int c0, int W,
                                          bool vec, uint4 u) {
  if (vec) {
    *reinterpret_cast<uint4*>(p + c0) = u;
    return;
  }
  unsigned short* ps = reinterpret_cast<unsigned short*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (c0 + e < W) ps[c0 + e] = (unsigned short)(w[e >> 1] >> (16 * (e & 1)));
}

// the norm weight's 8 columns of vector j (0 past W)
__device__ __forceinline__ void load_w8(const Row& row, int j, float* w) {
  const int c0 = j * VEC;
  if (row.vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row.w + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row.w + c0 + 4));
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w[e] = c0 + e < row.W ? row.w[c0 + e] : 0.f;
  }
}

// y *= r * w (as (y * r) * w, the plain version's order)
__device__ __forceinline__ void norm8(const float* w, float r, float* y) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) y[e] = __fmul_rn(__fmul_rn(y[e], r), w[e]);
}

// round to nearest even and saturate to [-128, 127] in one instruction
__device__ __forceinline__ int cvt_s8(float t) {
  int r;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(r) : "f"(t));
  return r;
}

struct Add {
  template <typename T>
  __device__ static T op(T a, T b) { return a + b; }
};
struct Max {
  __device__ static float op(float a, float b) { return fmaxf(a, b); }
};

// v reduced over the block; every thread gets the result, summed in warp
// order. red is free again when it returns.
template <typename Op, typename T>
__device__ T block_reduce(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = Op::op(r, red[i]);
  __syncthreads();
  return r;
}

// The row in registers: modes 0-2 keep it as loaded bf16 (mode 2: the
// rounded h), 4 registers a vector, and form y when a pass needs it; mode 3
// keeps y = silu(g) * u in f32, 8 a vector, since it costs an exp and a
// division to form again.
template <int MODE, int VPT>
struct Held {
  static constexpr bool F32 = MODE == SILU_MUL;
  uint4 raw[F32 ? 1 : VPT];
  float y[F32 ? VPT : 1][VEC];

  // vector j into slot v: x, h = bf16(x + d) (stored when store_h), or
  // silu(g) * u
  __device__ __forceinline__ void load(const Row& r, int v, int j,
                                       bool store_h) {
    const int c0 = j * VEC;
    if (MODE == SILU_MUL) {
      float g[VEC], u[VEC];
      unpack8(load_raw(r.x, c0, r.W, r.vec), g);
      unpack8(load_raw(r.x + r.W, c0, r.W, r.vec), u);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        y[F32 ? v : 0][e] =
            __fmul_rn(__fdiv_rn(g[e], __fadd_rn(1.f, expf(-g[e]))), u[e]);
    } else {
      uint4 a = load_raw(r.x, c0, r.W, r.vec);
      if (MODE == ADD_RMSNORM) {
        a = add_round(a, load_raw(r.d, c0, r.W, r.vec));
        if (store_h) store_raw(r.h, c0, r.W, r.vec, a);
      }
      raw[F32 ? 0 : v] = a;
    }
  }
  __device__ __forceinline__ void zero(int v) {
    if (F32) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[F32 ? v : 0][e] = 0.f;
    } else {
      raw[F32 ? 0 : v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the held values of slot v (before the norm)
  __device__ __forceinline__ void get(int v, float* f) const {
    if (F32) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = y[F32 ? v : 0][e];
    } else {
      unpack8(raw[F32 ? 0 : v], f);
    }
  }
};

template <int MODE, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_quant_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ d,
                   const float* __restrict__ w, __nv_bfloat16* __restrict__ h,
                   int8_t* __restrict__ q, float* __restrict__ scale,
                   float* __restrict__ asum, int W, float eps, int chunks,
                   int vec) {
  __shared__ float red_f[MAX_WARPS];
  __shared__ int red_i[MAX_WARPS];
  const size_t row = blockIdx.x;
  const int nt = blockDim.x, tid = threadIdx.x;
  Row r;
  r.x = x + row * (size_t)W * (MODE == SILU_MUL ? 2 : 1);
  r.d = MODE == ADD_RMSNORM ? d + row * (size_t)W : nullptr;
  r.w = w;
  r.h = MODE == ADD_RMSNORM ? h + row * (size_t)W : nullptr;
  r.q = q + row * (size_t)W;
  r.W = W;
  r.nv = (W + VEC - 1) / VEC;
  r.vec = vec != 0;
  constexpr bool NORM = MODE == RMSNORM || MODE == ADD_RMSNORM;

  Held<MODE, VPT> held;
  auto vec_of = [&](int c, int v) { return (c * VPT + v) * nt + tid; };
  auto load_chunk = [&](int c, bool store_h) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int j = vec_of(c, v);
      if (j < r.nv)
        held.load(r, v, j, store_h);
      else
        held.zero(v);
    }
  };
  // y of slot v of chunk c: the held values, normed in modes 1 and 2
  auto y_of = [&](int c, int v, float rs, float* y) {
    held.get(v, y);
    if (NORM && vec_of(c, v) < r.nv) {
      float wv[VEC];
      load_w8(r, vec_of(c, v), wv);
      norm8(wv, rs, y);
    }
  };

  // pass 1 (norm modes): the sum of squares; mode 2 stores h here
  float rs = 1.f;
  if (NORM) {
    float ss = 0.f;
    for (int c = 0; c < chunks; ++c) {
      load_chunk(c, true);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        float f[VEC];
        held.get(v, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    ss = block_reduce<Add>(ss, red_f);
    rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)W), eps)));
  }
  // pass 2: amax of y (a one-chunk row is still in registers)
  float amax = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (!NORM || chunks > 1) load_chunk(c, false);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float y[VEC];
      y_of(c, v, rs, y);
#pragma unroll
      for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(y[e]));
    }
  }
  amax = block_reduce<Max>(amax, red_f);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  const float inv = __frcp_rn(sc);
  // pass 3: the codes and their sum
  int qsum = 0;
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) load_chunk(c, false);
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int j = vec_of(c, v);
      if (j >= r.nv) continue;
      float y[VEC];
      y_of(c, v, rs, y);
      uint32_t qw[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        // y * (1 / sc) lies within 2.3e-5 of the IEEE quotient (|y / sc|
        // <= 127): it rounds to the same code unless a half-way point is
        // that close, and there the quotient itself decides
        const float t = __fmul_rn(y[e], inv);
        int qi = cvt_s8(t);
        if (fabsf(fabsf(t - (float)qi) - 0.5f) < 1e-4f)
          qi = cvt_s8(__fdiv_rn(y[e], sc));
        qw[e >> 2] |= ((uint32_t)qi & 0xFFu) << (8 * (e & 3));
        qsum += qi;  // columns past W hold y = 0: code 0
        if (!r.vec && j * VEC + e < W) r.q[j * VEC + e] = (int8_t)qi;
      }
      if (r.vec)
        *reinterpret_cast<uint2*>(r.q + j * VEC) = make_uint2(qw[0], qw[1]);
    }
  }
  qsum = block_reduce<Add>(qsum, red_i);
  if (tid == 0) {
    scale[row] = sc;
    asum[row] = __fmul_rn((float)qsum, sc);  // exact: |sum| < 2^24
  }
}

template <int MODE>
cudaError_t launch_mode(int vpt, dim3 grid, int threads, cudaStream_t s,
                        const __nv_bfloat16* x, const __nv_bfloat16* d,
                        const float* w, __nv_bfloat16* h, int8_t* q,
                        float* scale, float* asum, int W, float eps,
                        int chunks, int vec) {
  // mode 3 is instantiated up to MAX_VPT_F32 vectors a thread
  constexpr int TOP = MODE == SILU_MUL ? MAX_VPT_F32 : 8;
#define QS_K1(V)                                                         \
  case V:                                                                \
    fused_quant_kernel<MODE, (V <= TOP ? V : 1)><<<grid, threads, 0, s>>>( \
        x, d, w, h, q, scale, asum, W, eps, chunks, vec);                \
    break;
  if (vpt > TOP) return cudaErrorInvalidValue;
  switch (vpt) {
    QS_K1(1) QS_K1(2) QS_K1(3) QS_K1(4) QS_K1(5) QS_K1(6) QS_K1(7) QS_K1(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef QS_K1
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

}  // namespace

// d, w, h may be null where the mode reads or writes none. threads (a
// multiple of 32, at most 1024), vpt (1-8, mode 3 1-4) and chunks come from
// the host's launch_shape(W, mode 3): threads * vpt * chunks * 8 >= W.
extern "C" int qs_fused_quant(int mode, const void* x, const void* d,
                              const void* w, void* h, void* q, void* scale,
                              void* asum, int T, int W, float eps, int threads,
                              int vpt, int chunks, void* stream) {
  if (T <= 0 || W <= 0 || threads <= 0 || threads > MAX_THREADS ||
      threads % 32 != 0 || chunks <= 0 ||
      (long long)threads * vpt * chunks * VEC < W)
    return (int)cudaErrorInvalidValue;
  const int vec = W % VEC == 0 && aligned(x, 16) && aligned(d, 16) &&
                  aligned(w, 16) && aligned(h, 16) && aligned(q, 8);
  const dim3 grid(T);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* db = (const __nv_bfloat16*)d;
  auto* hb = (__nv_bfloat16*)h;
  cudaError_t e;
  switch (mode) {
#define QS_MODE(M)                                                            \
  case M:                                                                     \
    e = launch_mode<M>(vpt, grid, threads, s, xb, db, (const float*)w, hb,    \
                       (int8_t*)q, (float*)scale, (float*)asum, W, eps,      \
                       chunks, vec);                                          \
    break;
    QS_MODE(QUANT) QS_MODE(RMSNORM) QS_MODE(ADD_RMSNORM) QS_MODE(SILU_MUL)
#undef QS_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
