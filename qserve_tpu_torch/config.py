"""Engine configuration objects (a copy of qserve_tpu/config.py, which the
port may not import: that package's __init__ loads JAX). The defaults are
the JAX package's, so both engines read the same configuration."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Precision strings accepted by the CLI (reference: engine/arg_utils.py:404-413).
_PRECISIONS = (
    "w4a8kv4",
    "w4a8kv8",
    "w4a8",  # alias for w4a8kv8 in the reference
    "w8a8kv4",
    "w8a8kv8",
    "w8a8",
    "w16a16kv4",
    "w16a16kv8",
    "w16a16",
)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Parsed precision string: weight/activation/KV bit-widths."""

    weight_bits: int  # 4, 8 or 16
    act_bits: int  # 8 or 16
    kv_bits: int  # 4 or 8
    kv_zero_point: bool = True  # asymmetric KV quant (kv_zp in the reference)
    group_size: int = -1  # -1 = per-channel, else e.g. 128
    # lm_head weight bits: 16 = bf16 (reference parity: the reference always
    # serves lm_head fp16); 8 = W8A8 per-channel (beyond-reference: halves the
    # ~1GB/step of lm_head weight streaming at 8B scale, near-lossless)
    lm_head_bits: int = 16

    @staticmethod
    def from_precision(precision: str, group_size: int = -1, kv_zp: bool = True,
                       lm_head_bits: int = 16):
        p = precision.lower()
        if p not in _PRECISIONS:
            raise ValueError(f"unsupported precision {precision!r}; one of {_PRECISIONS}")
        wbits = int(p[1:].split("a")[0])
        abits = int(p.split("a")[1].split("kv")[0])
        kv = p.split("kv")[1] if "kv" in p else "8"
        return QuantSpec(
            weight_bits=wbits,
            act_bits=abits,
            kv_bits=int(kv),
            kv_zero_point=kv_zp,
            group_size=group_size,
            lm_head_bits=lm_head_bits,
        )

    @property
    def precision(self) -> str:
        return f"w{self.weight_bits}a{self.act_bits}kv{self.kv_bits}"


@dataclasses.dataclass
class ModelConfig:
    """Model identity + HF config introspection (reference config.py:63-185)."""

    model: str  # HF path or local dir
    tokenizer: Optional[str] = None
    tokenizer_mode: str = "auto"
    trust_remote_code: bool = True
    seed: int = 0
    dtype: str = "bfloat16"
    max_model_len: int = 8192
    hf_config: object = None  # transformers.PretrainedConfig, filled lazily
    quant_path: Optional[str] = None
    is_vlm: bool = False

    def load_hf_config(self):
        if self.hf_config is None:
            from transformers import AutoConfig

            self.hf_config = AutoConfig.from_pretrained(
                self.model, trust_remote_code=self.trust_remote_code
            )
        return self.hf_config

    # -- introspection helpers mirroring the reference's semantics --
    def get_hidden_size(self) -> int:
        return self.load_hf_config().hidden_size

    def get_head_size(self) -> int:
        cfg = self.load_hf_config()
        return getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_attention_heads

    def get_num_attention_heads(self) -> int:
        return self.load_hf_config().num_attention_heads

    def get_num_kv_heads(self, tp_size: int = 1) -> int:
        cfg = self.load_hf_config()
        n = getattr(cfg, "num_key_value_heads", None) or cfg.num_attention_heads
        return max(1, n // tp_size)

    def get_num_layers(self, pp_size: int = 1) -> int:
        return self.load_hf_config().num_hidden_layers // pp_size

    def get_vocab_size(self) -> int:
        return self.load_hf_config().vocab_size


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache geometry (reference config.py:188-249).

    bytes-per-page accounting for the device arrays: data int8 (or packed int4) +
    fp32 scale/zero per (token, kv_head) — stored as separate arrays rather
    than the reference's inline byte-offset layout (cache_engine.py:60-66).
    """

    block_size: int = 64  # tokens per page
    gpu_memory_utilization: float = 0.5
    swap_space_gb: int = 0
    num_device_pages: Optional[int] = None  # None = auto-size
    num_cpu_pages: int = 0
    # Mistral-style sliding window (tokens): the block manager reuses pages
    # cyclically past it and the attention kernels mask to it; None = full
    sliding_window: Optional[int] = None
    # each layer's window (None: all keys), where the model gives them: the
    # scheduler counts the page slots held wholly below a layer's window
    layer_windows: Tuple[Optional[int], ...] = ()
    quant: QuantSpec = dataclasses.field(
        default_factory=lambda: QuantSpec.from_precision("w4a8kv4")
    )

    def bytes_per_page(self, num_kv_heads: int, head_size: int) -> int:
        data = self.block_size * num_kv_heads * head_size
        if self.quant.kv_bits == 4:
            data //= 2
        scales = self.block_size * num_kv_heads * 4 * 2  # f32 scale + zero
        return 2 * (data + scales)  # K and V


@dataclasses.dataclass
class ParallelConfig:
    """Mesh axes. TP shards attention heads / MLP channels; DP replicates
    the engine; PP reserved (like the reference, serving uses TP+DP first)."""

    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    pipeline_parallel_size: int = 1

    def __post_init__(self) -> None:
        if self.pipeline_parallel_size != 1:
            # match the reference's explicit rejection (config.py:281-282)
            # rather than silently ignoring the flag
            raise NotImplementedError("Pipeline parallelism is not supported yet.")

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.data_parallel_size
            * self.pipeline_parallel_size
        )


@dataclasses.dataclass
class SchedulerConfig:
    """Continuous-batching limits (reference config.py:308-354)."""

    max_num_batched_tokens: int = 2048
    max_num_seqs: int = 256
    max_model_len: int = 8192
    delay_factor: float = 0.0
    # serve prompts longer than max_num_batched_tokens in page-aligned
    # chunks (and skip computed shared prefixes); False restores the
    # reference's behavior of rejecting them (ref scheduler.py:192-201)
    enable_chunked_prefill: bool = True
    # let a prefill chunk share its step with the running decode batch
    # (one fused [T+B] stream) so decodes never stall during a multi-chunk
    # admission; False restores chunk-alone steps
    mixed_chunk_decode: bool = True


@dataclasses.dataclass
class IFBConfig:
    """In-flight batching toggle (reference config.py:357-361)."""

    ifb_mode: bool = True


@dataclasses.dataclass
class ProfilingConfig:
    """Synthetic-benchmark shape: fixed prompt/gen lengths with random tokens
    (reference config.py:364-370)."""

    prompt_len: int = 1024
    generation_len: int = 512


@dataclasses.dataclass
class DeviceConfig:
    device: str = "cuda"
