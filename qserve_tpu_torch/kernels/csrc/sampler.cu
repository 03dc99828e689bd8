// Filtered (top-k / top-p) token sampling, for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_sampler.py _sample_call
// (_sample_kernel).
//
// x [B, V] f32, the logits already divided by the temperature; keff [B]
// int32 (top-k, V = off); p [B] f32 (top-p, floored at 1e-9 by the caller,
// >= 1 = off); optional gumbel [B, V] f32 noise -> out [B] int32. Per row:
//   * values map to monotone int32 keys (non-negative floats keep their
//     bits, negative floats flip their low 31 bits), so a bisection on keys
//     ends between adjacent representable floats and the kept sets are exact;
//   * top-k: the largest key t in [rowmin_key - 1, rowmax_key) with
//     #{key > t} >= keff; kept = {key > t}: the k largest plus ties;
//   * top-p: over probs = exp(x - lse) of the top-k kept set, the largest
//     key t in [kept_min_key - 1, rowmax_key) with mass{key > t} >= p; if
//     even the start has less mass (p near 1 and an f32 sum under 1) every
//     probe fails and everything is kept;
//   * the draw is argmax(x + g) over the kept set, lowest index on ties,
//     g = -log(-log u) from the noise operand or from Philox-4x32-10 keyed
//     by the 64-bit seed with counter (column, row, offset): 23 high bits
//     -> u in [2^-24, 1).
// Intervals are carried in uint32 (key ^ 0x80000000) so hi - lo cannot
// overflow. A bisection stops once hi - lo <= 1 (no later probe can move
// lo), and a row whose own filter is off (keff >= V, p >= 1) skips that
// bisection: its answer is the keep-all start. do_topk / do_topp are the
// host's decision that no row of the batch uses the filter at all.
//
// What bounds it on an H100: the bytes of the row, read once from HBM
// (B * V * 4); every later pass finds it in L2.
//
// Design: one block of 1024 threads per row. A row of V = 128256 f32 (513
// KB) fits neither the registers of a block (64 per thread at 1024 threads)
// nor its shared memory, so every probe re-reads the row, strided and
// coalesced, from L2 (64 rows are 32.8 MB of the 50 MB L2), recomputing the
// key (and exp(x - lse) for the kept values of a top-p probe) on the fly,
// and reduces across the block through warp shuffles and one shared array.
// The sums are taken in a fixed order, so a draw repeats bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t TOP = 0x80000000u;

__device__ __forceinline__ int key_of(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ uint32_t to_u(int s) { return (uint32_t)s ^ TOP; }
__device__ __forceinline__ int to_s(uint32_t u) { return (int)(u ^ TOP); }

struct Sum {
  __device__ static float op(float a, float b) { return a + b; }
};
struct MaxI {
  __device__ static int op(int a, int b) { return max(a, b); }
};
struct MinI {
  __device__ static int op(int a, int b) { return min(a, b); }
};
struct SumI {
  __device__ static int op(int a, int b) { return a + b; }
};

// Reduce v across the block in a fixed order; every thread gets the result.
template <typename Op, typename T>
__device__ T block_reduce(T v, T* red, T identity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Op::op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = (threadIdx.x & 31) < WARPS ? red[threadIdx.x & 31] : identity;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    r = Op::op(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// Philox-4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3"); returns the first output word.
__device__ __forceinline__ uint32_t philox(uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3,
                                           uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

__global__ void __launch_bounds__(THREADS)
sample_filtered_kernel(const float* __restrict__ x,
                       const int* __restrict__ keff,
                       const float* __restrict__ p,
                       const float* __restrict__ gumbel,
                       unsigned long long seed, unsigned long long offset,
                       int* __restrict__ out, int V, int do_topk,
                       int do_topp) {
  __shared__ int red_i[WARPS];
  __shared__ float red_f[WARPS];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = x + (size_t)b * V;

  int kmax = INT_MIN, kmin = INT_MAX;
  for (int i = tid; i < V; i += THREADS) {
    const int key = key_of(row[i]);
    kmax = max(kmax, key);
    kmin = min(kmin, key);
  }
  const int rowmax_k = block_reduce<MaxI>(kmax, red_i, INT_MIN);
  const int rowmin_k = block_reduce<MinI>(kmin, red_i, INT_MAX);

  // kept = {key > thr}
  int thr = rowmin_k - 1;
  const int k = keff[b];
  if (do_topk && k < V) {
    uint32_t lo = to_u(rowmin_k - 1), hi = to_u(rowmax_k);
    for (int it = 0; it < 32 && hi - lo > 1; ++it) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      const int t = to_s(mid);
      int c = 0;
      for (int i = tid; i < V; i += THREADS) c += key_of(row[i]) > t;
      if (block_reduce<SumI>(c, red_i, 0) >= k)
        lo = mid;
      else
        hi = mid;
    }
    thr = to_s(lo);
  }

  const float pt = p[b];
  if (do_topp && pt < 1.0f) {
    // the row's maximum is always kept; excluded values weigh exactly 0
    const int mb = rowmax_k >= 0 ? rowmax_k : rowmax_k ^ 0x7FFFFFFF;
    const float rowmax = __int_as_float(mb);
    float se = 0.f;
    int kept_min = INT_MAX;
    for (int i = tid; i < V; i += THREADS) {
      const float xv = row[i];
      const int key = key_of(xv);
      if (key > thr) {
        se += expf(xv - rowmax);
        kept_min = min(kept_min, key);
      }
    }
    const float lse = rowmax + logf(block_reduce<Sum>(se, red_f, 0.f));
    const int kept_min_k = block_reduce<MinI>(kept_min, red_i, INT_MAX);
    uint32_t lo = to_u(kept_min_k - 1), hi = to_u(rowmax_k);
    for (int it = 0; it < 32 && hi - lo > 1; ++it) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      const int t = to_s(mid);  // t >= kept_min_k - 1 >= thr
      float mass = 0.f;
      for (int i = tid; i < V; i += THREADS) {
        const float xv = row[i];
        if (key_of(xv) > t) mass += expf(xv - lse);
      }
      if (block_reduce<Sum>(mass, red_f, 0.f) >= pt)
        lo = mid;
      else
        hi = mid;
    }
    thr = max(thr, to_s(lo));
  }

  // Gumbel-argmax over the kept set, lowest index on equal maxima
  float best = -INFINITY;
  int best_i = V;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint32_t o0 = (uint32_t)offset, o1 = (uint32_t)(offset >> 32);
  for (int i = tid; i < V; i += THREADS) {
    const float xv = row[i];
    if (key_of(xv) <= thr) continue;
    float g;
    if (gumbel != nullptr) {
      g = gumbel[(size_t)b * V + i];
    } else {
      const uint32_t r = philox((uint32_t)i, (uint32_t)b, o0, o1, k0, k1);
      const float u =
          (float)(r >> 9) * (1.0f / 8388608.0f) + (1.0f / 16777216.0f);
      g = -logf(-logf(u));
    }
    const float y = xv + g;
    if (y > best || best_i == V) {  // i rises: the first of equal maxima stays
      best = y;
      best_i = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  __syncthreads();
  if ((tid & 31) == 0) {
    red_f[tid >> 5] = best;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid < 32) {
    best = tid < WARPS ? red_f[tid] : -INFINITY;
    best_i = tid < WARPS ? red_i[tid] : V;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (tid == 0) out[b] = best_i;
  }
}

}  // namespace

// gumbel may be null: the kernel then draws its own noise from (seed, offset).
extern "C" int qs_sample_filtered(const void* x, const void* keff,
                                  const void* p, const void* gumbel,
                                  unsigned long long seed,
                                  unsigned long long offset, void* out, int B,
                                  int V, int do_topk, int do_topp,
                                  void* stream) {
  sample_filtered_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)keff, (const float*)p,
      (const float*)gumbel, seed, offset, (int*)out, V, do_topk, do_topp);
  return (int)cudaGetLastError();
}
