"""Worker: owns ModelRunner + CacheEngine (qserve_tpu/worker/worker.py)."""

from __future__ import annotations

from typing import List, Tuple

from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
from qserve_tpu_torch.core.scheduler import SchedulerOutputs
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.sequence import SequenceGroupMetadata
from qserve_tpu_torch.worker.cache_engine import CacheEngine
from qserve_tpu_torch.worker.model_runner import ModelRunner


class Worker:
    def __init__(self, model_runner: ModelRunner, cache_engine: CacheEngine) -> None:
        self.model_runner = model_runner
        self.cache_engine = cache_engine

    @classmethod
    def create(
        cls,
        model_args: llama.LlamaArgs,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        params=None,
        seed: int = 0,
        device="cuda",
        benchmarking: bool = False,
    ) -> "Worker":
        kw = dict(
            max_model_len=scheduler_config.max_model_len,
            block_size=cache_config.block_size,
            max_num_batched_tokens=scheduler_config.max_num_batched_tokens,
            max_num_seqs=scheduler_config.max_num_seqs,
            device=device,
            benchmarking=benchmarking,
        )
        if params is None:
            runner = ModelRunner.from_random(model_args, seed=seed, **kw)
        else:
            runner = ModelRunner(params, model_args, rng_seed=seed, **kw)
        cache_engine = CacheEngine(
            num_layers=model_args.num_layers,
            num_kv_heads=model_args.num_kv_heads,
            head_dim=model_args.head_dim,
            cache_config=cache_config,
            device=device,
        )
        return cls(runner, cache_engine)

    def execute_model(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        scheduler_outputs: SchedulerOutputs,
    ) -> List[Tuple[int, int]]:
        # cache maintenance first (CoW copies, swaps), then the model step
        self.cache_engine.swap_out(scheduler_outputs.blocks_to_swap_out)
        self.cache_engine.swap_in(scheduler_outputs.blocks_to_swap_in)
        self.cache_engine.copy(scheduler_outputs.blocks_to_copy)
        if not seq_group_metadata_list:
            return []
        if scheduler_outputs.prompt_run:
            prompt_mds = [md for md in seq_group_metadata_list if md.is_prompt]
            decode_mds = [md for md in seq_group_metadata_list if not md.is_prompt]
            if decode_mds:
                # mixed step: one prefill chunk + the running decode batch
                assert len(prompt_mds) == 1
                return self.model_runner.execute_chunk_with_decode(
                    prompt_mds[0], decode_mds, self.cache_engine
                )
            return self.model_runner.execute_prefill(prompt_mds, self.cache_engine)
        return self.model_runner.execute_decode(
            seq_group_metadata_list, self.cache_engine
        )
