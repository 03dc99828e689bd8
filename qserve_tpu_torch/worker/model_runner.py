"""Model runner: marshals scheduler output into prefill / decode steps
(qserve_tpu/worker/model_runner.py).

Shapes are bucketed as in the JAX package (prefill tokens to a power of two
>= 16, decode batch to a power of two), so the kernels see the same padded
shapes. Sampling runs on the device; only the sampled ids [B] cross back.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from qserve_tpu_torch import native
from qserve_tpu_torch.layers import sampler as sampler_mod
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.sequence import SequenceGroupMetadata
from qserve_tpu_torch.utils.utils import bucket, resolve_device

_SAMPLING_EPS = 1e-5


def chunked_prefill_unported() -> NotImplementedError:
    return NotImplementedError(
        "chunked prefill / prefix-continuation steps need the prefix-prefill "
        "attention kernel (pallas_prefix_attention.prefix_prefill_attention_"
        "pallas), not ported yet: ROADMAP queue 1, item 8 (chunked prefill); "
        "serve with enable_chunked_prefill=False, as the port's EngineArgs does"
    )


def sample_host(
    logits: np.ndarray, sp, rng: np.random.Generator, count: int
) -> List[int]:
    """Draw `count` tokens from one logits row with sp's temperature /
    top-k / top-p on the host (only for the extra best_of candidates of a
    prompt, off the hot path)."""
    logits = np.asarray(logits, np.float64)
    if sp.temperature < _SAMPLING_EPS:
        return [int(np.argmax(logits))] * count
    scaled = logits / sp.temperature
    V = scaled.shape[0]
    if sp.top_k not in (-1, 0) and sp.top_k < V:
        kth = np.partition(scaled, -sp.top_k)[-sp.top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    if sp.top_p < 1.0:
        order = np.argsort(scaled)[::-1]
        probs = np.exp(scaled[order] - np.max(scaled))
        probs /= probs.sum()
        keep = (np.cumsum(probs) - probs) < sp.top_p
        thresh = np.min(np.where(keep, scaled[order], np.inf))
        scaled = np.where(scaled >= thresh, scaled, -np.inf)
    p = np.exp(scaled - np.max(scaled))
    p /= p.sum()
    return [int(t) for t in rng.choice(V, size=count, p=p)]


class ModelRunner:
    """Holds model params and runs the prefill / decode steps."""

    # n>1 / best_of>1 prompts: extra candidates host-sampled from the
    # prefill logits
    supports_multi_sample = True

    def __init__(
        self,
        params: llama.LlamaParams,
        model_args: llama.LlamaArgs,
        max_model_len: int,
        block_size: int,
        max_num_batched_tokens: int = 2048,
        max_num_seqs: int = 256,
        rng_seed: int = 0,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.model_args = model_args
        self.block_size = block_size
        self.max_pages_per_seq = -(-max_model_len // block_size)
        self.max_num_batched_tokens = max_num_batched_tokens
        self.max_num_seqs = max_num_seqs
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._host_rng = np.random.default_rng(rng_seed + 1)
        # seq_id -> extra candidate tokens from the latest prefill (best_of>1)
        self.last_extra_samples: Dict[int, List[int]] = {}

    @classmethod
    def from_random(
        cls,
        model_args: llama.LlamaArgs,
        max_model_len: int,
        block_size: int,
        seed: int = 0,
        device="cuda",
        **kw,
    ) -> "ModelRunner":
        params = llama.random_quantized_params(seed, model_args, device=device)
        return cls(params, model_args, max_model_len, block_size,
                   rng_seed=seed, device=device, **kw)

    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    @staticmethod
    def _sampling_arrays(per_seq_params, pad_to: int):
        """Host tensors (temperature, top_p, top_k) [pad_to]."""
        temp = np.zeros(pad_to, np.float32)
        topp = np.ones(pad_to, np.float32)
        topk = np.zeros(pad_to, np.int32)
        for i, sp in enumerate(per_seq_params):
            temp[i] = 0.0 if sp.temperature < _SAMPLING_EPS else sp.temperature
            topp[i] = sp.top_p
            topk[i] = 0 if sp.top_k in (-1, 0) else sp.top_k
        return torch.from_numpy(temp), torch.from_numpy(topp), torch.from_numpy(topk)

    def _sample(self, logits, sp_list, pad_to) -> torch.Tensor:
        temp, topp, topk = self._sampling_arrays(sp_list, pad_to)
        return sampler_mod.sample(logits, temp, topp, topk, self.generator)

    # ------------------------------------------------------------------
    def execute_prefill(
        self,
        metadata: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        """Returns [(seq_id, sampled_token)] in schedule order."""
        if any(md.chunk is not None and md.chunk[0] > 0 for md in metadata):
            raise chunked_prefill_unported()

        prompts: List[List[int]] = []
        tables: List[List[int]] = []
        seq_order: List[int] = []
        sp_list = []
        for md in metadata:
            for seq_id, data in md.seq_data.items():
                ids = data.get_token_ids()
                if md.chunk is not None and md.chunk[1] < data.get_len():
                    raise chunked_prefill_unported()
                prompts.append(ids)
                tables.append(md.block_tables[seq_id])
                seq_order.append(seq_id)
                sp_list.append(md.sampling_params)

        total = sum(len(p) for p in prompts)
        T = bucket(total, 16, self.max_num_batched_tokens * 2)
        B = bucket(len(seq_order), 1, self.max_num_seqs)
        tok, pos, sg, pg, sl, _, li, _ = native.pack_prefill(
            prompts, tables, self.block_size, T, B
        )
        logits, cache_engine.cache = llama.prefill(
            self.params, cache_engine.cache,
            *map(self._dev, (tok, pos, sg, pg, sl, li)),
            self.model_args,
        )
        toks = self._sample(logits, sp_list, B)

        self.last_extra_samples = {}
        if any(sp.best_of > 1 for sp in sp_list):
            logits_np = logits.float().cpu().numpy()
            for i, (sid, sp) in enumerate(zip(seq_order, sp_list)):
                if sp.best_of > 1:
                    self.last_extra_samples[sid] = sample_host(
                        logits_np[i], sp, self._host_rng, sp.best_of - 1
                    )
        out = toks.cpu().numpy()
        return [(sid, int(out[i])) for i, sid in enumerate(seq_order)]

    # ------------------------------------------------------------------
    def execute_decode(
        self,
        metadata: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        seq_order: List[int] = []
        tokens: List[int] = []
        ctx: List[int] = []
        tables: List[List[int]] = []
        sp_list = []
        for md in metadata:
            for seq_id, data in md.seq_data.items():
                seq_order.append(seq_id)
                tokens.append(data.get_last_token_id())
                ctx.append(data.get_len())
                tables.append(md.block_tables[seq_id])
                sp_list.append(md.sampling_params)

        B = bucket(len(seq_order), 1, self.max_num_seqs)
        tok, cl, bt = native.pack_decode(
            tokens, ctx, tables, B, self.max_pages_per_seq
        )
        logits, cache_engine.cache = llama.decode(
            self.params, cache_engine.cache,
            *map(self._dev, (tok, bt, cl)), self.model_args,
        )
        toks = self._sample(logits, sp_list, B)
        self.last_extra_samples = {}
        out = toks.cpu().numpy()
        return [(sid, int(out[i])) for i, sid in enumerate(seq_order)]
