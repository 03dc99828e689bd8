"""Device KV page pool: allocation, copy-on-write page copies, CPU swap
(qserve_tpu/worker/cache_engine.py). Copies and swaps update the cache
tensors in place.

Under tensor parallelism each rank's cache holds its own num_kv_heads /
tp_size heads: shard r of the JAX package's kv-head-sharded cache, in its
shard-local row order (scales rows [scales ++ zeros] of the rank's heads),
with the scale dtype the JAX package picks for the global head count."""

from __future__ import annotations

from typing import Dict, List

import torch

from qserve_tpu_torch.config import CacheConfig
from qserve_tpu_torch.kernels import kv_cache as kvc
from qserve_tpu_torch.utils.utils import resolve_device


class CacheEngine:
    """Owns the device KVCache tensors + a host-side swap pool."""

    def __init__(
        self,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        cache_config: CacheConfig,
        device="cuda",
        tp_size: int = 1,
    ) -> None:
        """num_kv_heads is the model's; the cache holds num_kv_heads //
        tp_size of them."""
        assert num_kv_heads % tp_size == 0, (num_kv_heads, tp_size)
        self.cache_config = cache_config
        self.block_size = cache_config.block_size
        self.num_pages = cache_config.num_device_pages
        assert self.num_pages, "num_device_pages must be resolved before CacheEngine"
        self.kv_bits = cache_config.quant.kv_bits
        self.device = resolve_device(device)
        self.cache = kvc.create_kv_cache(
            num_layers, self.num_pages, num_kv_heads // tp_size, self.block_size,
            head_dim, kv_bits=self.kv_bits, device=self.device,
            scale_dtype=kvc.scale_dtype_for(num_kv_heads),
        )
        self.cpu_pool: Dict[int, List[torch.Tensor]] = {}  # cpu page -> arrays

    def copy(self, blocks_to_copy: Dict[int, List[int]]) -> None:
        """cache[:, dst] = cache[:, src] for every layer array (CoW)."""
        if not blocks_to_copy:
            return
        src = [s for s, ds in blocks_to_copy.items() for _ in ds]
        dst = [d for ds in blocks_to_copy.values() for d in ds]
        src_t = torch.tensor(src, dtype=torch.long, device=self.device)
        dst_t = torch.tensor(dst, dtype=torch.long, device=self.device)
        for a in self.cache:
            a[:, dst_t] = a[:, src_t]

    def swap_out(self, mapping: Dict[int, int]) -> None:
        """device page -> cpu page (host copy)."""
        if not mapping:
            return
        pages = torch.tensor(list(mapping.keys()), dtype=torch.long, device=self.device)
        host = [a[:, pages].cpu() for a in self.cache]
        for i, cpu_page in enumerate(mapping.values()):
            self.cpu_pool[cpu_page] = [a[:, i].clone() for a in host]

    def swap_in(self, mapping: Dict[int, int]) -> None:
        """cpu page -> device page."""
        for cpu_page, dev_page in mapping.items():
            for a, h in zip(self.cache, self.cpu_pool.pop(cpu_page)):
                a[:, dev_page] = h.to(self.device)

    @staticmethod
    def page_bytes(
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        cache_config: CacheConfig,
    ) -> int:
        dc = head_dim // 2 if cache_config.quant.kv_bits == 4 else head_dim
        ps = cache_config.block_size
        # data [2, ps, H, Dc] int8 + scales [2, ps, H, 2] f32
        per_layer = 2 * ps * num_kv_heads * dc + 2 * ps * num_kv_heads * 2 * 4
        return num_layers * per_layer
