// KV-cache append: scatter quantized token rows into their (page, slot).
//
// Replaces: qserve_tpu/kernels/pallas_kv_append.py kv_append_inplace (the
// decode append) and kv_write_pages_inplace (the prefill page write), with
// the staging, searchsorted gather and page dedup that fed the latter
// (qserve_tpu/kernels/kv_cache.py append_all_layers).
//
// rows int8 [L, T, 2, H*Dc], sc [L, T, 2, 2H] (the cache's scale dtype),
// page_ids/slots int32 [T] -> in place: data[l, page, kv, slot, :] = rows
// [l, t, kv, :] and scales[l, page, kv, j, slot] = sc[l, t, kv, j]. Tokens
// with page -1 (padding) are dropped. Two tokens never share a slot, so
// blocks never write the same bytes; duplicate pages from prefix sharing
// receive identical bytes. Quantization stays outside, in plain PyTorch,
// where the JAX package ran it in XLA.
//
// What bounds it on an H100: the bytes of the rows and scales, read once and
// written once (3.35 TB/s); at decode the launch itself dominates.
//
// Design: one block per (token, layer) writes its two packed rows with
// 16-byte stores and its 4H scale values into the slot lane of the page's
// [2, 2H, ps] scale block. On the TPU whole pages had to be staged and
// DMA'd; a GPU scatters rows directly, so there is no staging buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
kv_append_kernel(const int8_t* __restrict__ rows, const uint8_t* __restrict__ sc,
                 int8_t* __restrict__ data, uint8_t* __restrict__ scales,
                 const int* __restrict__ page_ids, const int* __restrict__ slots,
                 int T, int P, int ps, int HDc, int H2, int scale_bytes) {
  const int t = blockIdx.x, l = blockIdx.y, tid = threadIdx.x;
  const int page = page_ids[t];
  if (page < 0) return;
  const int slot = slots[t];
  for (int kv = 0; kv < 2; ++kv) {
    const int8_t* src = rows + (((size_t)l * T + t) * 2 + kv) * HDc;
    int8_t* dst = data + ((((size_t)l * P + page) * 2 + kv) * ps + slot) * HDc;
    if (HDc % 16 == 0) {
      for (int i = tid; i < HDc / 16; i += THREADS)
        reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    } else {
      for (int i = tid; i < HDc; i += THREADS) dst[i] = src[i];
    }
    for (int j = tid; j < H2; j += THREADS) {
      const size_t s_off = (((size_t)l * T + t) * 2 + kv) * H2 + j;
      const size_t d_off = ((((size_t)l * P + page) * 2 + kv) * H2 + j) * ps + slot;
      if (scale_bytes == 2)
        reinterpret_cast<uint16_t*>(scales)[d_off] =
            reinterpret_cast<const uint16_t*>(sc)[s_off];
      else
        reinterpret_cast<uint32_t*>(scales)[d_off] =
            reinterpret_cast<const uint32_t*>(sc)[s_off];
    }
  }
}

}  // namespace

// data [L, P, 2, ps, HDc] int8, scales [L, P, 2, H2, ps] (2- or 4-byte
// elements), rows [L, T, 2, HDc], sc [L, T, 2, H2], page_ids/slots [T].
extern "C" int qs_kv_append(const void* rows, const void* sc, void* data,
                            void* scales, const void* page_ids,
                            const void* slots, int L, int T, int P, int ps,
                            int HDc, int H2, int scale_bytes, void* stream) {
  if (T == 0 || L == 0) return 0;
  const dim3 grid(T, L);
  kv_append_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)rows, (const uint8_t*)sc, (int8_t*)data, (uint8_t*)scales,
      (const int*)page_ids, (const int*)slots, T, P, ps, HDc, H2, scale_bytes);
  return (int)cudaGetLastError();
}
