// Causal flash attention over a packed varlen prefill stream, for Hopper.
//
// Replaces: qserve_tpu/kernels/pallas_flash_attention.py
// flash_prefill_attention_pallas.
//
// q [T, Hq, D], k/v [T, Hkv, D] bf16, seg [T] int32 (0 = padding, >0 =
// sequence id; each sequence one contiguous run of the stream, as the engine
// packs it) -> out [T, Hq, D] bf16. Query row t attends key s when
// seg[s] == seg[t] > 0 and s <= t (and s > t - window when window > 0).
// Rows with no key to attend (padding) come out exactly 0, as in the TPU
// kernel (NEG_INF = -1e30 with l floored at 1e-30). Any T is accepted.
//
// What bounds it on an H100: causal attention at T = 2048 does about
// 4 * Hq * D flops per live (query, key) pair, far above the bytes it moves
// (q, k, v, out once each), so it is bound by arithmetic: 989 TFLOP/s in
// bf16 on the tensor cores.
//
// Design (attn_common.cuh): one block of 4 warps per (kv head, tile of
// 64 / rep query tokens); the rep query heads of the kv head fold into the
// block's 64 rows (GQA), so each K/V tile in shared memory serves all of
// them. QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16
// operands from ldmatrix, f32 accumulators); P is rounded to bf16 for PV as
// the TPU kernel does, m and l stay f32 from the unrounded p. 64-key tiles
// of K and V (and their segment ids) are filled by cp.async, double-buffered:
// tile j + 1 loads while tile j computes. The key loop starts at the first
// key of the query tile's first segment (found by a backward scan of seg,
// which relies on contiguous segments) or at the window's lower edge, and
// stops at the causal limit: the cross-segment tiles the earlier kernel
// walked from key 0 are gone; a tile wholly inside the causal and window
// limits of every row skips the mask. Blocks are launched latest query tile first,
// the heaviest causal work first. What remains above the bound: mma.sync
// reaches a fraction of Hopper's wgmma rate, and the masks and online
// softmax run on the CUDA cores beside it.

#include "attn_common.cuh"

using namespace qs_attn;

namespace {

constexpr int BLOCK_THREADS = 128;  // 4 warps, 64 folded query rows

// Query tokens per block: the 64 rows hold rep x bq of them, so a rep that
// does not divide 64 (3, 5, 6, 7) leaves 64 - rep * bq rows dead (masked,
// never written).
__host__ __device__ __forceinline__ int tokens_per_block(int rep) {
  return 64 / rep;
}

template <int D>
__global__ void __launch_bounds__(BLOCK_THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                     int T, int Hq, int Hkv, float sm_scale, int window) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][K,V][BK][LD]
  int* segk = reinterpret_cast<int*>(tiles + 2 * 2 * BK * LD);   // [2][BK]
  __shared__ int seg_start;

  const int rep = Hq / Hkv;
  const int bq = tokens_per_block(rep);
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;  // latest tile first
  const int qlast = min(q0 + bq, T) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float c = sm_scale * LOG2E;

  int qpos[2], qseg[2];
  const __nv_bfloat16* qrow[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int hr = r / bq, t = q0 + r % bq;
    const bool ok = hr < rep && t < T;
    const size_t off = ((size_t)t * Hq + h * rep + hr) * D;
    qpos[i] = t;
    qseg[i] = ok ? seg[t] : 0;
    qrow[i] = ok ? q + off : nullptr;
    orow[i] = ok ? out + off : nullptr;
  }
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, qrow);

  // first key: the start of the run of seg[q0] (a padding token starts no
  // run: its tile's live rows begin later), or the window's lower edge
  const int s0 = seg[q0];
  if (tid == 0) seg_start = 0;
  __syncthreads();
  int kstart = q0;
  if (s0 > 0) {
    for (int base = q0 - 1; base >= 0; base -= BLOCK_THREADS) {
      const int j = base - tid;
      const bool other = j >= 0 && seg[j] != s0;
      if (other) atomicMax(&seg_start, j + 1);
      if (__syncthreads_or(other)) break;
    }
    kstart = seg_start;
  }
  if (window > 0) kstart = max(kstart, q0 - window + 1);
  const int n = (qlast - kstart) / BK + 1;
  // every token of the query tile in the run of seg[q0], so every key from
  // kstart on is of their prompt
  const bool full = s0 > 0 && seg[qlast] == s0;

  auto issue = [&](int it) {
    const int k0 = kstart + it * BK, b = it & 1;
    stage_bf16_tile_async<D, BLOCK_THREADS>(tiles + (b * 2) * BK * LD,
                                            tiles + (b * 2 + 1) * BK * LD, k, v,
                                            k0, T, Hkv, h);
    if (tid < BK) {
      const int s = k0 + tid;
      cp_async4(segk + b * BK + tid, seg + (s < T ? s : 0), s < T);
    }
    cp_async_commit();
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  issue(0);
  for (int it = 0; it < n; ++it) {
    const int b = it & 1, k0 = kstart + it * BK;
    if (it + 1 < n) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* sk = segk + b * BK;
    const __nv_bfloat16* Ks = tiles + (b * 2) * BK * LD;
    // a tile of the query tile's own prompt, wholly before it and inside the
    // window, needs no mask
    const bool whole =
        full && k0 + BK - 1 <= q0 && (window <= 0 || k0 > qlast - window);
    attend_tile<D>(
        qa, Ks, Ks + BK * LD,
        [&](float acc, int i, int j) {
          const int s = k0 + j;
          bool ok = qseg[i] > 0 && sk[j] == qseg[i] && s <= qpos[i];
          if (window > 0) ok = ok && s > qpos[i] - window;
          return whole || ok ? acc * c : NEG_INF;
        },
        [](float p, int, int) { return p; }, m, l, z, o);
    __syncthreads();
  }
  store_rows<D>(o, l, z, orow);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, int T, int Hq, int Hkv, float sm_scale, int window,
           cudaStream_t st) {
  constexpr int LD = D + 8;
  constexpr int smem = 2 * 2 * BK * LD * 2 + 2 * BK * 4;
  static bool attr = false;  // dynamic shared memory above 48 KB
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int bq = tokens_per_block(Hq / Hkv);
  const dim3 grid(Hkv, (T + bq - 1) / bq);
  flash_prefill_kernel<D><<<grid, BLOCK_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out, T, Hq,
      Hkv, sm_scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// 128 threads per block; the wrapper keeps Hq / Hkv <= 8 and D in
// {64, 96, 128, 256}.
extern "C" int qs_flash_prefill_attention(const void* q, const void* k,
                                          const void* v, const void* seg,
                                          void* out, int T, int Hq, int Hkv,
                                          int D, float sm_scale, int window,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch<128>(q, k, v, seg, out, T, Hq, Hkv, sm_scale, window, st);
  if (D == 64) return launch<64>(q, k, v, seg, out, T, Hq, Hkv, sm_scale, window, st);
  if (D == 96) return launch<96>(q, k, v, seg, out, T, Hq, Hkv, sm_scale, window, st);
  if (D == 256) return launch<256>(q, k, v, seg, out, T, Hq, Hkv, sm_scale, window, st);
  return (int)cudaErrorInvalidValue;
}
