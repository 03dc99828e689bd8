"""Worker: owns ModelRunner + CacheEngine (qserve_tpu/worker/worker.py)."""

from __future__ import annotations

from typing import List, Tuple

from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
from qserve_tpu_torch.core.scheduler import SchedulerOutputs
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.sequence import SequenceGroupMetadata
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.worker.cache_engine import CacheEngine
from qserve_tpu_torch.worker.model_runner import ModelRunner


class Worker:
    def __init__(self, model_runner: ModelRunner, cache_engine: CacheEngine) -> None:
        self.model_runner = model_runner
        self.cache_engine = cache_engine
        # the decode step's CUDA graphs, over the cache now that it exists
        model_runner.capture_decode_graphs(cache_engine)

    @classmethod
    def _wire(
        cls,
        make_runner,
        model_args: llama.LlamaArgs,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        device,
        tp_size: int = 1,
        **runner_kw,
    ) -> "Worker":
        """The runner make_runner(**keywords) returns, given the keywords
        every runner takes from the configs and `runner_kw`; then the cache
        of model_args' layers and this rank's kv heads, made after the
        runner, so that a runner that makes its weights does so before the
        KV pool takes its memory."""
        runner = make_runner(
            max_model_len=scheduler_config.max_model_len,
            block_size=cache_config.block_size,
            max_num_batched_tokens=scheduler_config.max_num_batched_tokens,
            max_num_seqs=scheduler_config.max_num_seqs,
            device=device,
            **runner_kw,
        )
        cache_engine = CacheEngine(
            num_layers=model_args.num_layers,
            num_kv_heads=model_args.num_kv_heads,
            head_dim=model_args.head_dim,
            cache_config=cache_config,
            device=device,
            tp_size=tp_size,
        )
        return cls(runner, cache_engine)

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
        def make_runner(**kw):
            if params is None:
                return ModelRunner.from_random(model_args, seed=seed, **kw)
            return ModelRunner(params, model_args, rng_seed=seed, **kw)

        return cls._wire(make_runner, model_args, cache_config, scheduler_config, device,
                         benchmarking=benchmarking)

    @classmethod
    def create_tp(
        cls,
        float_params,
        model_args: llama.LlamaArgs,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        tp_size: int,
        dp_size: int = 1,
        seed: int = 0,
        device="cuda",
        params=None,
    ) -> "Worker":
        """Tensor-parallel worker of this rank (qserve_tpu/worker/worker.py
        create_tp): its shards of `float_params` (or its ready `params`,
        with float_params None) and a cache of its kv heads. The TP group
        must exist (parallel/distributed.py)."""
        from qserve_tpu_torch.worker.tp_runner import TPModelRunner

        def make_runner(**kw):
            if params is not None:
                return TPModelRunner(params, model_args, tp_size=tp_size, rng_seed=seed, **kw)
            return TPModelRunner.from_float_tp(
                float_params, model_args, tp_size=tp_size, rng_seed=seed, **kw)

        return cls._wire(make_runner, model_args, cache_config, scheduler_config, device,
                         tp_size=tp_size, dp_size=dp_size)

    @classmethod
    def create_vlm(
        cls,
        vila_args,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        params=None,
        seed: int = 0,
        device="cuda",
    ) -> "Worker":
        """VLM worker: VLMModelRunner over the same cache machinery."""
        from qserve_tpu_torch.worker.vlm_runner import VLMModelRunner

        def make_runner(**kw):
            if params is None:
                return VLMModelRunner.from_random_vlm(vila_args, seed=seed, **kw)
            return VLMModelRunner(params, vila_args, rng_seed=seed, **kw)

        return cls._wire(make_runner, vila_args.llm, cache_config, scheduler_config, device)

    def execute_model(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        scheduler_outputs: SchedulerOutputs,
    ) -> List[Tuple[int, int]]:
        # cache maintenance first (CoW copies, swaps), then the model step
        out = scheduler_outputs
        if out.blocks_to_swap_out or out.blocks_to_swap_in or out.blocks_to_copy:
            with tracing.span("worker.cache_ops"):
                self.cache_engine.swap_out(out.blocks_to_swap_out)
                self.cache_engine.swap_in(out.blocks_to_swap_in)
                self.cache_engine.copy(out.blocks_to_copy)
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
