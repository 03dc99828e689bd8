"""EngineArgs: the CLI flag surface -> config objects -> engine
(qserve_tpu/engine/arg_utils.py).

The port builds a dense Llama, or a Mixtral sparse-MoE model when the config
has `num_local_experts`, with random weights (`random_weights=True`, the
geometry from a config dict or a model dir's config.json) on one device,
at any precision of config._PRECISIONS (W4A8, W8A8 or W16A16 over a KV4 or
KV8 cache), per-channel or per-group W4 (`group_size`), with a bf16 or a W8
lm_head (`quant_lm_head`), and with the scheduler's defaults (chunked
prefill and mixed chunk+decode steps on). Real checkpoints, VLM and TP/DP
raise NotImplementedError naming their ROADMAP items.

The CLI takes every flag of qserve_tpu's, so its command lines parse here.
Flags with no meaning in the port (--no-ifb-mode, --no-scan-layers, the
profiling lengths, -pp, --trust-remote-code) are accepted and ignored; the
flags of unported items (--benchmarking, --quant-path, --tokenizer,
--tokenizer-mode, --img-per-seq) parse and then raise in build_engine. The
NUM_GPU_PAGE_BLOCKS environment variable sets the page count when
--num-device-pages is not given, as in qserve_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from qserve_tpu_torch.config import CacheConfig, QuantSpec, SchedulerConfig
from qserve_tpu_torch.logger import init_logger

logger = init_logger(__name__)


@dataclasses.dataclass
class EngineArgs:
    model: str = ""
    tokenizer: Optional[str] = None
    tokenizer_mode: str = "auto"
    trust_remote_code: bool = True  # accepted, ignored: no remote code runs
    # Hugging Face config.json contents; with random_weights it replaces
    # reading `model`/config.json
    hf_config: Optional[dict] = None
    seed: int = 0
    device: str = "cuda"
    # quantization
    precision: str = "w4a8kv4"
    group_size: int = -1
    kv_zero_point: bool = True
    quant_lm_head: bool = False
    quant_path: Optional[str] = None
    # kv cache
    block_size: int = 256
    num_device_pages: Optional[int] = None
    num_cpu_pages: int = 0
    gpu_memory_utilization: float = 0.5
    # scheduler
    max_num_batched_tokens: int = 2048
    max_num_seqs: int = 64
    max_model_len: int = 2048
    # parallel
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1  # accepted, ignored (as in qserve_tpu)
    # engine
    ifb_mode: bool = True  # accepted, ignored: the scheduler always batches in flight
    benchmarking: bool = False
    profiling_prompt_len: Optional[int] = None  # accepted, ignored
    profiling_generation_len: Optional[int] = None  # accepted, ignored
    random_weights: bool = False
    scan_layers: bool = True  # accepted, ignored: layers run in a Python loop
    disable_log_stats: bool = True
    # VLM
    run_vlm: bool = False
    img_per_seq: int = 1

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        g = parser.add_argument
        g("--model", type=str, default="", help="local HF model dir (config.json)")
        g("--tokenizer", type=str, default=None)
        g("--tokenizer-mode", type=str, default="auto", choices=["auto", "slow"])
        g("--trust-remote-code", action="store_true", default=True)
        g("--seed", type=int, default=0)
        g("--device", type=str, default="cuda")
        g("--precision", type=str, default="w4a8kv4",
          help="w4a8kv4|w4a8kv8|w8a8kv4|w8a8kv8|w16a16kv4|w16a16kv8")
        g("--group-size", type=int, default=-1,
          help="-1 per-channel, or e.g. 128 for per-group W4")
        g("--no-kv-zero-point", dest="kv_zero_point", action="store_false")
        g("--quant-lm-head", action="store_true")
        g("--quant-path", type=str, default=None,
          help="packed QoQ checkpoint (not ported yet)")
        g("--block-size", type=int, default=256)
        g("--num-device-pages", type=int, default=None,
          help="KV pages on the card (auto-sized if omitted; the "
               "NUM_GPU_PAGE_BLOCKS env is honoured)")
        g("--num-cpu-pages", type=int, default=0)
        g("--gpu-memory-utilization", type=float, default=0.5)
        g("--max-num-batched-tokens", type=int, default=2048)
        g("--max-num-seqs", type=int, default=64)
        g("--max-model-len", type=int, default=2048)
        g("--tensor-parallel-size", "-tp", type=int, default=1)
        g("--data-parallel-size", "-dp", type=int, default=1)
        g("--pipeline-parallel-size", "-pp", type=int, default=1)
        g("--no-ifb-mode", dest="ifb_mode", action="store_false")
        g("--benchmarking", action="store_true",
          help="device-feed decode (not ported yet)")
        g("--profiling-prompt-len", type=int, default=None)
        g("--profiling-generation-len", type=int, default=None)
        g("--random-weights", action="store_true")
        g("--no-scan-layers", dest="scan_layers", action="store_false")
        g("--run-vlm", action="store_true")
        g("--img-per-seq", type=int, default=1)
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "EngineArgs":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in fields})

    # ------------------------------------------------------------------
    def quant_spec(self) -> QuantSpec:
        return QuantSpec.from_precision(
            self.precision, self.group_size, self.kv_zero_point,
            lm_head_bits=8 if self.quant_lm_head else 16,
        )

    def create_engine_configs(self):
        quant = self.quant_spec()
        env_pages = os.environ.get("NUM_GPU_PAGE_BLOCKS")
        cache_config = CacheConfig(
            block_size=self.block_size,
            gpu_memory_utilization=self.gpu_memory_utilization,
            num_device_pages=(
                self.num_device_pages
                if self.num_device_pages is not None
                else (int(env_pages) if env_pages else None)
            ),
            num_cpu_pages=self.num_cpu_pages,
            quant=quant,
        )
        scheduler_config = SchedulerConfig(
            max_num_batched_tokens=self.max_num_batched_tokens,
            max_num_seqs=self.max_num_seqs,
            max_model_len=self.max_model_len,
        )
        return cache_config, scheduler_config

    def _refuse_unported(self) -> None:
        if self.run_vlm or self.img_per_seq != 1:
            raise NotImplementedError("VLM is not ported yet (ROADMAP queue 1, VLM)")
        if self.benchmarking:
            raise NotImplementedError(
                "the benchmarking device-feed mode is not ported yet (ROADMAP "
                "queue 1, the runner's benchmarking device-feed mode)"
            )
        if self.quant_path or self.tokenizer or self.tokenizer_mode != "auto":
            raise NotImplementedError(
                "checkpoints and tokenizers are not ported yet (ROADMAP queue "
                "1, the checkpoint loader, with the tokenizer)"
            )
        if self.tensor_parallel_size > 1 or self.data_parallel_size > 1:
            raise NotImplementedError(
                "tensor/data parallelism is not ported yet (ROADMAP queue 1, TP)"
            )
        if not self.random_weights:
            raise NotImplementedError(
                "checkpoint loading is not ported yet (ROADMAP queue 1, the "
                "checkpoint loader); use random_weights=True"
            )

    def model_config_dict(self) -> dict:
        if self.hf_config is not None:
            return self.hf_config
        with open(os.path.join(self.model, "config.json")) as f:
            return json.load(f)

    # ------------------------------------------------------------------
    def build_engine(self):
        """Construct the engine (random init included)."""
        from qserve_tpu_torch.engine.llm_engine import LLMEngine
        from qserve_tpu_torch.models import llama, mixtral
        from qserve_tpu_torch.worker.worker import Worker

        self._refuse_unported()
        cache_config, scheduler_config = self.create_engine_configs()
        cfg = self.model_config_dict()
        # an MoE config builds MoE layers (the JAX package's single-device
        # random-weight path read it as a dense model of the same widths)
        if cfg.get("num_local_experts"):
            args = mixtral.args_from_config_dict(cfg, self.quant_spec())
            build = mixtral.random_quantized_params
        else:
            args = llama.LlamaArgs.from_config_dict(cfg, self.quant_spec())
            build = llama.random_quantized_params
        if args.sliding_window is not None:
            cache_config.sliding_window = args.sliding_window
        # params before the cache: auto-sizing reads what the weights left free
        params = build(self.seed, args, self.device)
        if cache_config.num_device_pages is None:
            cache_config.num_device_pages = auto_num_pages(
                args, cache_config, self.gpu_memory_utilization, self.device
            )
            logger.info("Auto-sized KV cache: %d pages", cache_config.num_device_pages)
        worker = Worker.create(
            args, cache_config, scheduler_config, params=params,
            seed=self.seed, device=self.device,
        )
        return LLMEngine(
            worker, scheduler_config, cache_config,
            log_stats=not self.disable_log_stats,
        )


def auto_num_pages(model_args, cache_config: CacheConfig, mem_fraction: float,
                   device) -> int:
    """Size the page pool from free device memory."""
    import torch

    from qserve_tpu_torch.worker.cache_engine import CacheEngine

    page_bytes = CacheEngine.page_bytes(
        model_args.num_layers, model_args.num_kv_heads, model_args.head_dim,
        cache_config,
    )
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info()
    else:
        free = 8 << 30
    return max(16, int(free * mem_fraction) // page_bytes)
