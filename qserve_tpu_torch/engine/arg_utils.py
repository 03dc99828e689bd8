"""EngineArgs: the CLI flag surface -> config objects -> engine
(qserve_tpu/engine/arg_utils.py).

The port builds a dense Llama, or a Mixtral sparse-MoE model, on one
device, at any precision of config._PRECISIONS (W4A8, W8A8 or W16A16 over
a KV4 or KV8 cache), per-channel or per-group W4 (`group_size`), with a
bf16 or a W8 lm_head (`quant_lm_head`), and with the scheduler's defaults
(chunked prefill and mixed chunk+decode steps on). Its weights come from
`model`, a local Hugging Face directory:

  * a float checkpoint there, quantized at load on `device`;
  * or, with `quant_path`, a packed QoQ checkpoint (dense Llama; either
    package's), read and moved to `device`;
  * or, with `random_weights`, seeded random weights of the geometry in
    its config.json (or in `hf_config`, a config dict, with no directory).

The tokenizer loads from `tokenizer` or `model` as in the JAX package; when
it cannot load, the engine serves token ids only and says so in a warning.
`benchmarking` keeps a stable decode batch's sampled ids on the device as
the next step's input (worker/model_runner.py).

With `run_vlm` it builds a VILA/LLaVA VLM (vision tower, projector and the
quantized LLM): from a VILA or LLaVA directory (models/loader.py
`load_vlm_model`), or with `random_weights` a CLIP-L/14-336 tower and an
`mlp_downsample` projector (144 tokens an image) over the LLM of the
config (`QSERVE_TPU_VISION_PRESET=tiny`: a 64-wide, 2-layer tower on
32-pixel images). Mixed chunk+decode steps are off for a VLM: its chunks
run alone.

With `tensor_parallel_size` N > 1 the engine is one rank of N processes
(parallel/distributed.py): launch it under `torchrun --nproc-per-node N`,
whose environment `build_engine` joins, or call init_distributed in each
rank first. Every rank runs the same scheduler on the same requests over
its own shard (Worker.create_tp): random weights, or a float HF checkpoint
that each rank quantizes per shard (`quant_path` is ignored, as in the JAX
package). Engine-level data parallelism (`data_parallel_size` > 1) and a
VLM at tp > 1 raise NotImplementedError naming ROADMAP.

The CLI takes every flag of qserve_tpu's, so its command lines parse here.
Flags with no meaning in the port (--no-ifb-mode, --no-scan-layers, the
profiling lengths, -pp) are accepted and ignored. The NUM_GPU_PAGE_BLOCKS
environment variable sets the page count when --num-device-pages is not
given, as in qserve_tpu.
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
    trust_remote_code: bool = True
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
    omit_vision_tower: bool = False  # True raises: the tower always runs

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
          help="packed QoQ checkpoint (from either package's checkpoint converter)")
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
          help="device-feed decode: a stable decode batch's sampled ids stay "
               "on the device as the next step's input (placeholder ids out)")
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
        if self.data_parallel_size > 1:
            # the JAX engine refuses it too: its TPModelRunner asserts dp == 1
            raise NotImplementedError(
                "engine-level data parallelism is not served: run one engine per "
                "replica (ROADMAP queue 3, standing divergences)"
            )
        if self.run_vlm and self.tensor_parallel_size > 1:
            raise NotImplementedError(
                "a VLM at tensor_parallel_size > 1 is not served (qserve_tpu builds the "
                "single-device VLM and ignores tp; ROADMAP, standing divergences)"
            )
        if self.omit_vision_tower:
            raise NotImplementedError(
                "omit_vision_tower is not served: the vision tower always runs (qserve_tpu "
                "accepts the flag and ignores it; ROADMAP, standing VLM divergences)"
            )

    def model_config_dict(self) -> dict:
        if self.hf_config is not None:
            return self.hf_config
        with open(os.path.join(self.model, "config.json")) as f:
            return json.load(f)

    # ------------------------------------------------------------------
    def build_engine(self):
        """Construct the engine (checkpoint load or random init included)."""
        from qserve_tpu_torch.engine.llm_engine import LLMEngine
        from qserve_tpu_torch.models import llama, loader, mixtral, vila
        from qserve_tpu_torch.worker.worker import Worker

        self._refuse_unported()
        cache_config, scheduler_config = self.create_engine_configs()
        quant = self.quant_spec()
        # params before the cache: auto-sizing reads what the weights left free
        vlm_args = vlm_params = None
        if self.run_vlm:
            if self.random_weights:
                vlm_args = self._random_vlm_args(quant)
                vlm_params = vila.random_params(self.seed, vlm_args, self.device)
            else:
                if self.hf_config is not None:
                    raise ValueError("hf_config serves random weights only")
                vlm_args, vlm_params = loader.load_vlm_model(
                    self.model, quant, quant_path=self.quant_path, device=self.device
                )
            args = vlm_args.llm
            # VLM prompts chunk through vila.vlm_prefill_chunk; the fused
            # chunk+decode step is the dense model's: VLM chunks run alone
            scheduler_config.mixed_chunk_decode = False
        elif self.tensor_parallel_size > 1:
            return self._build_tp_engine(quant, cache_config, scheduler_config)
        elif self.random_weights:
            args = self._random_args(quant)
            build = (mixtral if args.num_experts else llama).random_quantized_params
            params = build(self.seed, args, self.device)
        else:
            if self.hf_config is not None:
                raise ValueError(
                    "hf_config serves random weights only: a checkpoint needs "
                    "`model` to be its directory"
                )
            args, params = loader.load_model(
                self.model, quant, quant_path=self.quant_path, device=self.device
            )
        if args.sliding_window is not None:
            cache_config.sliding_window = args.sliding_window
        if cache_config.num_device_pages is None:
            cache_config.num_device_pages = auto_num_pages(
                args, cache_config, self.gpu_memory_utilization, self.device
            )
            logger.info("Auto-sized KV cache: %d pages", cache_config.num_device_pages)
        if self.run_vlm:
            worker = Worker.create_vlm(
                vlm_args, cache_config, scheduler_config, params=vlm_params,
                seed=self.seed, device=self.device,
            )
        else:
            worker = Worker.create(
                args, cache_config, scheduler_config, params=params,
                seed=self.seed, device=self.device, benchmarking=self.benchmarking,
            )
        return LLMEngine(
            worker, scheduler_config, cache_config, tokenizer=self.load_tokenizer(),
            log_stats=not self.disable_log_stats,
        )

    def _random_args(self, quant: QuantSpec):
        """LlamaArgs of the random-weight model of the config. An MoE config
        builds MoE layers (the JAX package's single-device random-weight
        path read it as a dense model of the same widths)."""
        from qserve_tpu_torch.models import llama, mixtral

        cfg = self.model_config_dict()
        if cfg.get("num_local_experts"):
            return mixtral.args_from_config_dict(cfg, quant)
        return llama.LlamaArgs.from_config_dict(cfg, quant)

    def _tp_device(self):
        """This rank's device once it is in a TP group of tensor_parallel_size
        ranks: the group that exists, else one joined from torchrun's
        environment."""
        import torch.distributed as dist

        from qserve_tpu_torch.parallel import distributed, tp as tpmod

        tp = self.tensor_parallel_size
        if dist.is_initialized():
            dev = distributed.rank_device(self.device)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            _, _, dev = distributed.init_distributed(tp, device=self.device)
        else:
            raise RuntimeError(
                f"tensor_parallel_size={tp} runs one process per rank: launch with "
                f"`torchrun --standalone --nproc-per-node {tp} -m "
                f"qserve_tpu_torch.entrypoints.benchmark -tp {tp} ...`, or call "
                "qserve_tpu_torch.parallel.distributed.init_distributed(tp_size) in "
                "each rank before build_engine")
        if tpmod.tp_world() != tp:
            raise RuntimeError(
                f"the TP group has {tpmod.tp_world()} ranks; tensor_parallel_size is {tp}")
        return dev

    def _build_tp_engine(self, quant, cache_config, scheduler_config):
        """This rank's engine at tensor_parallel_size > 1: random weights
        (random_quantized_params_tp of `seed`) or a float HF checkpoint, each
        rank quantizing its own shards; the page count is the least any rank
        can hold, so every rank's block manager is sized alike."""
        import dataclasses as dc

        from qserve_tpu_torch.engine.llm_engine import LLMEngine
        from qserve_tpu_torch.models import llama, loader, mixtral
        from qserve_tpu_torch.parallel import tp as tpmod
        from qserve_tpu_torch.worker.worker import Worker

        device = self._tp_device()
        tp = self.tensor_parallel_size
        if self.random_weights:
            args = dc.replace(self._random_args(quant), tp_size=tp)
            params = tpmod.random_quantized_params_tp(self.seed, args, tpmod.tp_rank(), device)
        else:
            if self.hf_config is not None:
                raise ValueError(
                    "hf_config serves random weights only: a checkpoint needs "
                    "`model` to be its directory")
            if self.quant_path:
                logger.warning("quant_path is ignored at tensor_parallel_size > 1: each "
                               "rank quantizes its shards of the float checkpoint")
            cfg = loader.load_hf_config_dict(self.model)
            if set(cfg.get("architectures", [])) & loader.MIXTRAL_ARCHS:
                args = mixtral.args_from_config_dict(cfg, quant)
                fp = mixtral.load_float_params_from_hf(self.model, args)
            else:
                args = llama.LlamaArgs.from_config_dict(cfg, quant)
                fp = loader.load_float_params_from_hf(self.model, args)
            args = dc.replace(args, tp_size=tp)
            params = tpmod.quantize_params_tp(fp, args, tpmod.tp_rank(), device)
            del fp
        if args.sliding_window is not None:
            cache_config.sliding_window = args.sliding_window
        if cache_config.num_device_pages is None:
            cache_config.num_device_pages = auto_num_pages(
                args, cache_config, self.gpu_memory_utilization, device)
        cache_config.num_device_pages = tpmod.group_min(cache_config.num_device_pages, device)
        logger.info("TP rank %d/%d: %d KV pages", tpmod.tp_rank(), tp,
                    cache_config.num_device_pages)
        worker = Worker.create_tp(
            None, args, cache_config, scheduler_config, tp_size=tp,
            dp_size=self.data_parallel_size, seed=self.seed, device=device, params=params)
        return LLMEngine(
            worker, scheduler_config, cache_config, tokenizer=self.load_tokenizer(),
            log_stats=not self.disable_log_stats,
        )

    def load_tokenizer(self):
        """The tokenizer of `tokenizer` or `model`, or None (token ids only)
        with a warning when it cannot load, as in the JAX package."""
        from qserve_tpu_torch.utils.tokenizer import get_tokenizer

        tok_path = self.tokenizer or self.model
        if self.run_vlm and os.path.isdir(os.path.join(tok_path, "llm")):
            tok_path = os.path.join(tok_path, "llm")  # VILA keeps it under llm/
        try:
            return get_tokenizer(tok_path, self.tokenizer_mode, self.trust_remote_code)
        except Exception as e:
            logger.warning("Tokenizer unavailable (%s); token-id-only mode", e)
            return None

    def _random_vlm_args(self, quant: QuantSpec):
        """Random-weight VLM geometry: a CLIP-L/14-336 tower
        (openai/clip-vit-large-patch14-336) and an mlp_downsample projector
        (24x24 grid -> 144 tokens an image) over the LLM of the config
        (`hf_config`, or `model`/config.json)."""
        from qserve_tpu_torch.models import clip, llama, mm_projector, vila

        largs = llama.LlamaArgs.from_config_dict(self.model_config_dict(), quant)
        if os.environ.get("QSERVE_TPU_VISION_PRESET") == "tiny":  # CPU smoke
            vargs = clip.VisionArgs(
                hidden_size=64, intermediate_size=128, num_layers=2,
                num_heads=4, image_size=32, patch_size=8,
            )
        else:
            vargs = clip.VisionArgs(
                hidden_size=1024, intermediate_size=4096, num_layers=24,
                num_heads=16, image_size=336, patch_size=14,
            )
        pargs = mm_projector.ProjectorArgs(
            kind="mlp_downsample", vision_hidden=vargs.hidden_size,
            llm_hidden=largs.hidden_size, grid=vargs.grid,
        )
        return vila.VilaArgs(llm=largs, vision=vargs, projector=pargs)


def auto_num_pages(model_args, cache_config: CacheConfig, mem_fraction: float,
                   device) -> int:
    """Size the page pool from free device memory. A TP rank's pages hold
    its own kv heads, and ranks that share a card split its fraction of the
    free memory (the caller then takes the group's least count)."""
    import torch

    from qserve_tpu_torch.parallel import distributed
    from qserve_tpu_torch.worker.cache_engine import CacheEngine

    page_bytes = CacheEngine.page_bytes(
        model_args.num_layers, model_args.num_kv_heads // model_args.tp_size,
        model_args.head_dim, cache_config,
    )
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = 8 << 30
    if model_args.tp_size > 1:
        mem_fraction /= distributed.ranks_per_device(device)
    return max(16, int(free * mem_fraction) // page_bytes)


@dataclasses.dataclass
class AsyncEngineArgs(EngineArgs):
    """Async-serving argument surface (qserve_tpu's, kept for API parity).

    engine_use_ray / worker_use_ray have no meaning here (one engine process
    drives one device); they are accepted and ignored so vLLM-style
    launchers keep working.
    """

    engine_use_ray: bool = False
    worker_use_ray: bool = False
    max_log_len: int = 0

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser = EngineArgs.add_cli_args(parser)
        parser.add_argument("--engine-use-ray", action="store_true")
        parser.add_argument("--worker-use-ray", action="store_true")
        parser.add_argument("--max-log-len", type=int, default=0)
        return parser
