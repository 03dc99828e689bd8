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
// overflow. Each search evaluates 4 thresholds a pass, splitting the
// interval evenly, and keeps the largest that passes and the smallest that
// fails; it stops once hi - lo <= 1, where a bisection would end on the
// same key. A row whose own filter is off (keff >= V, p >= 1) skips that
// search: its answer is the keep-all start. do_topk / do_topp are the
// host's decision that no row of the batch uses the filter at all.
//
// What bounds it on an H100: the bytes of the row, read once from HBM
// (B * V * 4).
//
// Design: a thread-block cluster of C CTAs (C <= 8, the portable size, and
// 256 threads a CTA, 512 past 8192 columns, chosen on the host from V:
// kernels/sampler.py cluster_split) owns a row; CTA r copies columns
// [r * S, r * S + S) of it once, by cp.async, into its shared memory
// (S = 16032 f32 = 62.6 KB at V = 128256) and turns them into keys there,
// and every later pass (min/max, each search pass, the log-sum-exp, the
// draw) reads shared memory. A row thus spreads over C SMs
// instead of one, and a pass reads 1/C of the row from shared memory
// instead of all of it from L2. What is left is the cluster barrier of each
// reduction, so a search pass evaluates 4 thresholds: ~14 passes where a
// bisection makes up to 32 barriers. Each reduction goes warp shuffles ->
// one partial a CTA, which warp 0 pushes into every CTA's inbox through
// distributed shared memory (map_shared_rank) -> one cluster barrier -> each
// CTA combines its inbox in rank order; the inboxes alternate between two
// halves, so one barrier a reduction suffices. The order is fixed, and every
// CTA of the cluster combines the same partials in it, so all of them take
// the same branch of each probe and a draw repeats bit for bit. The cluster
// size is a launch attribute (cudaLaunchKernelEx), not __cluster_dims__,
// since it follows V.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_WARPS = 16;  // a CTA runs 256 or 512 threads
constexpr int MAX_CLUSTER = 8;
constexpr int PROBES = 4;  // thresholds a search pass
constexpr int SLOT_WORDS = PROBES / 2;  // u64 words of the largest partial
constexpr uint32_t TOP = 0x80000000u;
typedef unsigned long long u64;

__device__ __forceinline__ int key_of(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float value_of(int key) {  // key_of's inverse
  return __int_as_float(key >= 0 ? key : key ^ 0x7FFFFFFF);
}
__device__ __forceinline__ uint32_t to_u(int s) { return (uint32_t)s ^ TOP; }
__device__ __forceinline__ int to_s(uint32_t u) { return (int)(u ^ TOP); }

struct Range {  // the row's largest and smallest key
  int mx, mn;
};
struct MassMin {  // sum of exp(x - rowmax) and the smallest key, kept set
  float se;
  int mn;
};
template <typename E>
struct Probes {  // a count or a mass at each threshold of a pass
  E v[PROBES];
};

__device__ __forceinline__ int shfl(int v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float shfl(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ u64 shfl(u64 v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ Range shfl(Range v, int o) {
  return {shfl(v.mx, o), shfl(v.mn, o)};
}
__device__ __forceinline__ MassMin shfl(MassMin v, int o) {
  return {shfl(v.se, o), shfl(v.mn, o)};
}
template <typename E>
__device__ __forceinline__ Probes<E> shfl(Probes<E> v, int o) {
#pragma unroll
  for (int j = 0; j < PROBES; ++j) v.v[j] = shfl(v.v[j], o);
  return v;
}

// Each reduction: op, and its identity (what a lane past the warps holds)
struct MaxU {
  __device__ static u64 id() { return 0; }
  __device__ static u64 op(u64 a, u64 b) { return a > b ? a : b; }
};
struct RangeOp {
  __device__ static Range id() { return {INT_MIN, INT_MAX}; }
  __device__ static Range op(Range a, Range b) {
    return {max(a.mx, b.mx), min(a.mn, b.mn)};
  }
};
struct MassMinOp {
  __device__ static MassMin id() { return {0.f, INT_MAX}; }
  __device__ static MassMin op(MassMin a, MassMin b) {
    return {a.se + b.se, min(a.mn, b.mn)};
  }
};
template <typename E>
struct SumProbes {
  __device__ static Probes<E> id() {
    Probes<E> r;
#pragma unroll
    for (int j = 0; j < PROBES; ++j) r.v[j] = 0;
    return r;
  }
  __device__ static Probes<E> op(Probes<E> a, const Probes<E>& b) {
#pragma unroll
    for (int j = 0; j < PROBES; ++j) a.v[j] += b.v[j];
    return a;
  }
};

struct Slot {
  u64 w[SLOT_WORDS];
};
template <typename T>
__device__ __forceinline__ Slot to_slot(const T& v) {
  static_assert(sizeof(T) <= sizeof(Slot), "a partial fits one slot");
  Slot b = {};
  memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T>
__device__ __forceinline__ T from_slot(const Slot& b) {
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

// The partial slots of a CTA and the cluster it belongs to.
struct Cluster {
  cg::cluster_group g;
  int n, rank;  // CTAs in the cluster, this CTA's rank
  Slot* red;    // [MAX_WARPS] this CTA's warp partials
  Slot* inbox;  // [2][MAX_CLUSTER] every CTA's partial, pushed by that CTA
  int phase;    // which half of the inbox this reduction fills

  // v reduced over the cluster in a fixed order: a warp's lanes by xor
  // tree, the CTA's warps by xor tree in warp 0 (identities past them),
  // the CTAs in rank order; every thread of every CTA gets the result.
  // Warp 0 pushes the CTA's partial into every CTA's inbox (remote stores
  // do not wait: a remote load would stall each read for the round trip),
  // so after the barrier each CTA reads its own shared memory only.
  template <typename Op, typename T>
  __device__ T reduce(T v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = Op::op(v, shfl(v, o));
    if (lane == 0) red[warp] = to_slot(v);
    __syncthreads();
    Slot* box = inbox + phase * MAX_CLUSTER;
    if (warp == 0) {
      T w = lane < (int)(blockDim.x >> 5) ? from_slot<T>(red[lane]) : Op::id();
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) w = Op::op(w, shfl(w, o));
      if (lane < n) *g.map_shared_rank(box + rank, lane) = to_slot(w);
    }
    // release the pushes, acquire the others'; a CTA fills this half
    // again two reductions on, after every CTA has passed the next barrier
    // and so finished reading it
    g.sync();
    T r = from_slot<T>(box[0]);
#pragma unroll
    for (int k = 1; k < MAX_CLUSTER; ++k)
      if (k < n) r = Op::op(r, from_slot<T>(box[k]));
    phase ^= 1;
    return r;
  }
};

// The largest key t in [lo, hi) with f(t) >= target, for f non-increasing
// with f(hi) < target (lo itself if f(lo) < target: no probe passes), in
// passes of PROBES thresholds splitting the interval evenly: 14 passes
// cover 2^32 keys where a bisection takes 32, each pass one cluster
// reduction. fill(t, part) adds this thread's f at thresholds t[0] < ... <
// t[PROBES - 1] into part; f is the same sum for a threshold whichever
// pass evaluates it, so the answer is the bisection's.
template <typename E, typename Fill, typename Ge>
__device__ int search(Cluster& cl, int lo_s, int hi_s, Fill fill, Ge ge) {
  uint32_t lo = to_u(lo_s), hi = to_u(hi_s);
  for (int it = 0; it < 32 && hi - lo > 1; ++it) {
    int t[PROBES];
    uint32_t m[PROBES];
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      m[j] = lo + (uint32_t)((u64)(hi - lo) * (j + 1) / (PROBES + 1));
      t[j] = to_s(m[j]);
    }
    Probes<E> part = SumProbes<E>::id();
    fill(t, part);
    const Probes<E> f = cl.reduce<SumProbes<E>>(part);
    uint32_t nlo = lo, nhi = hi;
#pragma unroll
    for (int j = 0; j < PROBES; ++j) {
      if (ge(f.v[j]))
        nlo = max(nlo, m[j]);
      else
        nhi = min(nhi, m[j]);
    }
    lo = nlo;
    hi = nhi;
  }
  return to_s(lo);
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

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
sample_filtered_kernel(const float* __restrict__ x,
                       const int* __restrict__ keff,
                       const float* __restrict__ p,
                       const float* __restrict__ gumbel,
                       unsigned long long seed, unsigned long long offset,
                       int* __restrict__ out, int V, int S, int do_topk,
                       int do_topp) {
  extern __shared__ float4 dyn[];
  float* sx = reinterpret_cast<float*>(dyn);  // this CTA's slice of the row
  int* sk = reinterpret_cast<int*>(dyn);      // the same, as keys
  __shared__ Slot red[MAX_WARPS];
  __shared__ Slot inbox[2 * MAX_CLUSTER];
  Cluster cl{cg::this_cluster(), 0, 0, red, inbox, 0};
  cl.n = (int)cl.g.num_blocks();
  const int rank = cl.rank = (int)cl.g.block_rank();
  const int b = blockIdx.x / cl.n, tid = threadIdx.x;
  const int c0 = rank * S;  // the slice's first column
  const int n = max(0, min(V - c0, S));

  // the slice, once from HBM
  const float* src = x + (size_t)b * V + c0;
  int i0 = 0;
  if (((uintptr_t)src & 15) == 0) {
    i0 = n & ~3;
    for (int i = 4 * tid; i < i0; i += 4 * THREADS)
      qs_async::cp_async16(sx + i, src + i, true);
  }
  for (int i = i0 + tid; i < n; i += THREADS)
    qs_async::cp_async4(sx + i, src + i, true);
  qs_async::cp_async_commit();
  qs_async::cp_async_wait<0>();
  __syncthreads();

  // the slice becomes keys in place; every later pass gives a thread the
  // same columns i = tid, tid + THREADS, ..., so it reads only its own
  Range rg{INT_MIN, INT_MAX};
  for (int i = tid; i < n; i += THREADS) {
    const int key = key_of(sx[i]);
    sk[i] = key;
    rg.mx = max(rg.mx, key);
    rg.mn = min(rg.mn, key);
  }
  rg = cl.reduce<RangeOp>(rg);
  const int rowmax_k = rg.mx, rowmin_k = rg.mn;

  // kept = {key > thr}
  int thr = rowmin_k - 1;
  const int k = keff[b];
  if (do_topk && k < V) {
    thr = search<int>(
        cl, rowmin_k - 1, rowmax_k,
        [&](const int* t, Probes<int>& c) {
          for (int i = tid; i < n; i += THREADS) {
            const int key = sk[i];
#pragma unroll
            for (int j = 0; j < PROBES; ++j) c.v[j] += key > t[j];
          }
        },
        [&](int count) { return count >= k; });
  }

  const float pt = p[b];
  if (do_topp && pt < 1.0f) {
    // the row's maximum is always kept; excluded values weigh exactly 0
    const int mb = rowmax_k >= 0 ? rowmax_k : rowmax_k ^ 0x7FFFFFFF;
    const float rowmax = __int_as_float(mb);
    MassMin mm{0.f, INT_MAX};
    for (int i = tid; i < n; i += THREADS) {
      const int key = sk[i];
      if (key > thr) {
        mm.se += expf(value_of(key) - rowmax);
        mm.mn = min(mm.mn, key);
      }
    }
    mm = cl.reduce<MassMinOp>(mm);
    const float lse = rowmax + logf(mm.se);
    // thresholds from kept_min_k - 1 >= thr: a mass counts kept values only
    const int lo_p = search<float>(
        cl, mm.mn - 1, rowmax_k,
        [&](const int* t, Probes<float>& mass) {
          for (int i = tid; i < n; i += THREADS) {
            const int key = sk[i];
            if (key > t[0]) {
              const float e = expf(value_of(key) - lse);
#pragma unroll
              for (int j = 0; j < PROBES; ++j)
                if (key > t[j]) mass.v[j] += e;
            }
          }
        },
        [&](float mass) { return mass >= pt; });
    thr = max(thr, lo_p);
  }

  // Gumbel-argmax over the kept set as one 64-bit maximum: the key of
  // x + g (-0 as +0, so equal values tie) over the column's complement
  // (the lowest column wins a tie)
  u64 best = 0;
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint32_t o0 = (uint32_t)offset, o1 = (uint32_t)(offset >> 32);
  for (int i = tid; i < n; i += THREADS) {
    const int key = sk[i];
    if (key <= thr) continue;
    const float xv = value_of(key);
    const int col = c0 + i;
    float g;
    if (gumbel != nullptr) {
      g = gumbel[(size_t)b * V + col];
    } else {
      const uint32_t r = philox((uint32_t)col, (uint32_t)b, o0, o1, k0, k1);
      const float u =
          (float)(r >> 9) * (1.0f / 8388608.0f) + (1.0f / 16777216.0f);
      g = -logf(-logf(u));
    }
    const float y = xv + g == 0.f ? 0.f : xv + g;
    best = MaxU::op(best, ((u64)to_u(key_of(y)) << 32) | (uint32_t)~col);
  }
  best = cl.reduce<MaxU>(best);
  if (rank == 0 && tid == 0) out[b] = best == 0 ? V : (int)~(uint32_t)best;
}

template <int THREADS>
int launch(const void* x, const void* keff, const void* p, const void* gumbel,
           unsigned long long seed, unsigned long long offset, void* out,
           int B, int V, int cluster, int slice, int do_topk, int do_topp,
           void* stream) {
  // the device's shared memory a block, less the kernel's static arrays;
  // the dynamic limit raised as far as a call has needed (one device)
  static size_t room = 0, raised = 0;
  const auto kernel = sample_filtered_kernel<THREADS>;
  const size_t smem = (size_t)slice * sizeof(float);
  cudaError_t e = cudaSuccess;
  if (room == 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    room = (size_t)optin - fa.sharedSizeBytes;
  }
  if (smem > room) return (int)cudaErrorInvalidValue;
  if (smem > raised) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const float*)x, (const int*)keff,
                         (const float*)p, (const float*)gumbel, seed, offset,
                         (int*)out, V, slice, do_topk, do_topp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// gumbel may be null: the kernel then draws its own noise from (seed, offset).
// cluster (1-8) CTAs a row, each of threads (256 or 512) threads holding
// slice columns (a multiple of 4, cluster * slice >= V): kernels/sampler.py
// cluster_split(V).
extern "C" int qs_sample_filtered(const void* x, const void* keff,
                                  const void* p, const void* gumbel,
                                  unsigned long long seed,
                                  unsigned long long offset, void* out, int B,
                                  int V, int cluster, int slice, int threads,
                                  int do_topk, int do_topp, void* stream) {
  if (B <= 0 || V <= 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      slice <= 0 || slice % 4 != 0 || (long long)cluster * slice < V ||
      (threads != 256 && threads != 512) ||
      (long long)B * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return threads == 512
             ? launch<512>(x, keff, p, gumbel, seed, offset, out, B, V, cluster,
                           slice, do_topk, do_topp, stream)
             : launch<256>(x, keff, p, gumbel, seed, offset, out, B, V, cluster,
                           slice, do_topk, do_topp, stream);
}
