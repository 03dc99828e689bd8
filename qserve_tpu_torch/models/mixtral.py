"""Mixtral (sparse-MoE Llama) parameter construction
(qserve_tpu/models/mixtral.py).

The forward lives in models/llama.py (`_moe_mlp`, chosen by the layers'
type, MoELayerParams); here the stacked per-expert weights are built:
random from a seeded generator on the device, or quantized from the JAX
package's float weight dict. Both quantize expert by expert into
preallocated stacked tensors, so the float model never exists whole
(Mixtral-8x7B would be ~187 GB in f32). Loading a Hugging Face checkpoint
waits for the port's checkpoint loader.
"""

from __future__ import annotations

import numpy as np
import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.utils.utils import resolve_device


def args_from_config_dict(cfg: dict, quant: QuantSpec) -> llama.LlamaArgs:
    """From a Hugging Face MixtralForCausalLM config.json dict."""
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    return llama.LlamaArgs(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=cfg.get("rope_theta", 1e6),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        sliding_window=cfg.get("sliding_window"),
        quant=quant,
        num_experts=cfg.get("num_local_experts", 8),
        moe_top_k=cfg.get("num_experts_per_tok", 2),
    )


def _stacked_moe_layers(args: llama.LlamaArgs, device, weight_of, router_of):
    """Quantize layer by layer, expert by expert, into preallocated stacked
    tensors. weight_of(li, name, shape, e) -> float [K, N] (e is None for
    qkv and o); router_of(li) -> f32 [E, NE]."""
    E, I, L, NE = args.hidden_size, args.intermediate_size, args.num_layers, args.num_experts
    q = args.quant
    attn = dict(qkv=(E, args.qkv_out), o=(args.q_size, E))
    experts = dict(gate_up=(E, 2 * I), down=(I, E))
    lins = {n: llama.empty_linear((L,), *s, device, q) for n, s in attn.items()}
    lins.update({n: llama.empty_linear((L, NE), *s, device, q)
                 for n, s in experts.items()})
    router = torch.empty((L, E, NE), dtype=torch.float32, device=device)
    for li in range(L):
        for name, shape in attn.items():
            llama.quantize_into(lins[name], li, weight_of(li, name, shape, None), q)
        router[li] = router_of(li)
        for e in range(NE):
            for name, shape in experts.items():
                llama.quantize_into(lins[name], (li, e), weight_of(li, name, shape, e), q)
    return llama.MoELayerParams(
        input_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        post_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        router=router,
        **lins,
    )


def random_quantized_params(
    seed: int, args: llama.LlamaArgs, device="cuda", scale: float = 0.02
) -> llama.LlamaParams:
    """Random MoE weights from a seeded torch.Generator, quantized expert by
    expert on the device."""
    assert args.num_experts > 0, "Mixtral params are MoE layers (num_experts > 0)"
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    E, V, NE = args.hidden_size, args.vocab_size, args.num_experts

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale

    layers = _stacked_moe_layers(
        args, device, lambda li, name, shape, e: randn(shape),
        lambda li: randn((E, NE)),
    )
    return llama.LlamaParams(
        embed=randn((V, E), torch.bfloat16),
        layers=layers,
        final_ln=torch.ones((E,), dtype=torch.float32, device=device),
        lm_head=llama.make_lm_head(randn((E, V), torch.bfloat16), args.quant),
    )


def quantize_params(float_params: dict, args: llama.LlamaArgs,
                    device="cuda") -> llama.LlamaParams:
    """Quantize float weights (the JAX package's mixtral.random_float_params
    dict: per layer qkv, o, router and the lists experts_gate_up,
    experts_down of [K, N] arrays) into the serving format."""
    device = resolve_device(device)

    def t(x, dtype=torch.float32):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # a writable copy
        return x.to(device=device, dtype=dtype)

    fl = float_params["layers"]

    def weight_of(li, name, shape, e):
        if e is None:
            return t(fl[li][name])
        return t(fl[li][f"experts_{name}"][e])

    layers = _stacked_moe_layers(args, device, weight_of, lambda li: t(fl[li]["router"]))
    layers = layers._replace(
        input_ln=torch.stack([t(x["input_ln"]) for x in fl]),
        post_ln=torch.stack([t(x["post_ln"]) for x in fl]),
    )
    return llama.LlamaParams(
        embed=t(float_params["embed"], torch.bfloat16),
        layers=layers,
        final_ln=t(float_params["final_ln"]),
        lm_head=llama.make_lm_head(t(float_params["lm_head"]), args.quant),
    )
