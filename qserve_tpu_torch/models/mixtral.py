"""Mixtral (sparse-MoE Llama) parameter construction
(qserve_tpu/models/mixtral.py).

The forward lives in models/llama.py (`_moe_mlp`, chosen by the layers'
type, MoELayerParams); here the stacked per-expert weights are built:
random from a seeded generator on the device, or quantized from a float
weight dict (the JAX package's layout, or a Hugging Face checkpoint's
through load_float_params_from_hf). Both quantize expert by expert into
preallocated stacked tensors, so the f32 model never exists whole
(Mixtral-8x7B would be ~187 GB in f32).
"""

from __future__ import annotations

import numpy as np
import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.parallel import tp as tpmod
from qserve_tpu_torch.utils.utils import resolve_device


def is_moe_config(cfg: dict) -> bool:
    """A Hugging Face config of a sparse-MoE model the port serves through
    MoE layers: Mixtral's (its architecture, or num_local_experts) or
    Mellum's (model_type "mellum")."""
    return ("MixtralForCausalLM" in cfg.get("architectures", ())
            or bool(cfg.get("num_local_experts")) or cfg.get("model_type") == "mellum")


def args_from_config_dict(cfg: dict, quant: QuantSpec) -> llama.LlamaArgs:
    """From a Hugging Face MixtralForCausalLM config.json dict, or Mellum's
    (model_type "mellum": `num_experts` experts of width
    `moe_intermediate_size`, every layer sparse; a window or a full layer
    each by `layer_types`, each layer type's RoPE in `rope_parameters`). The
    router is a softmax over every expert, its top `num_experts_per_tok`
    renormalised."""
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    n_exp = cfg.get("num_local_experts", cfg.get("num_experts"))
    if not n_exp:
        raise ValueError("an MoE config names its experts' count (num_local_experts "
                         "or num_experts)")
    if not cfg.get("norm_topk_prob", True):
        raise NotImplementedError("norm_topk_prob false: the port renormalises the top-k")
    if set(cfg.get("mlp_layer_types", ["sparse"])) != {"sparse"}:
        raise NotImplementedError("dense MLP layers among the sparse ones are not "
                                  "implemented by the port")
    if cfg.get("attention_bias"):
        raise NotImplementedError("attention_bias is not implemented by the port")
    return llama.LlamaArgs(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg.get("moe_intermediate_size", cfg["intermediate_size"]),
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        head_dim=head_dim,
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        quant=quant,
        num_experts=n_exp,
        moe_top_k=cfg.get("num_experts_per_tok", 2),
        **llama.attn_fields(cfg, 1e6),
    )


def _stacked_moe_layers(args: llama.LlamaArgs, device, weight_of, router_of,
                        rank: int = 0):
    """Quantize layer by layer, expert by expert, into preallocated stacked
    tensors. weight_of(li, name, shape, e) -> the full float [K, N] (e is
    None for qkv and o), cut to rank `rank`'s shard (parallel/tp.py: each
    expert's gate_up column-, its down row-parallel) and quantized on its
    own; router_of(li) -> f32 [E, NE], replicated."""
    E, L, NE = args.hidden_size, args.num_layers, args.num_experts
    q = args.quant
    shapes = args.linear_shapes()
    attn = {n: shapes[n] for n in ("qkv", "o")}
    experts = {n: shapes[n] for n in ("gate_up", "down")}
    lins = {n: llama.empty_linear((L,), *local, device, q) for n, (_, local) in attn.items()}
    lins.update({n: llama.empty_linear((L, NE), *local, device, q)
                 for n, (_, local) in experts.items()})
    router = torch.empty((L, E, NE), dtype=torch.float32, device=device)

    def shard(li, name, full, e):
        return tpmod.shard_weight(weight_of(li, name, full, e), name, args, rank)

    for li in range(L):
        for name, (full, _) in attn.items():
            llama.quantize_into(lins[name], li, shard(li, name, full, None), q)
        router[li] = router_of(li)
        for e in range(NE):
            for name, (full, _) in experts.items():
                llama.quantize_into(lins[name], (li, e), shard(li, name, full, e), q)
    return llama.MoELayerParams(
        input_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        post_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        router=router,
        **lins,
    )


def random_quantized_params(
    seed: int, args: llama.LlamaArgs, device="cuda", scale: float = 0.02,
    rank: int = 0,
) -> llama.LlamaParams:
    """Random MoE weights from a seeded torch.Generator, quantized expert by
    expert on the device. At tp_size > 1, rank `rank`'s shard of the same
    weights (parallel/tp.py random_quantized_params_tp)."""
    assert args.num_experts > 0, "Mixtral params are MoE layers (num_experts > 0)"
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    E, V, NE = args.hidden_size, args.vocab_size, args.num_experts

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale

    layers = _stacked_moe_layers(
        args, device, lambda li, name, shape, e: randn(shape),
        lambda li: randn((E, NE)), rank,
    )
    return llama.LlamaParams(
        embed=randn((V, E), torch.bfloat16),
        layers=layers,
        final_ln=torch.ones((E,), dtype=torch.float32, device=device),
        lm_head=llama.make_lm_head(
            tpmod.shard_vocab(randn((E, V), torch.bfloat16), args, rank), args.quant),
    )


def random_float_params(seed: int, args: llama.LlamaArgs, device="cpu",
                        scale: float = 0.02) -> dict:
    """Random float MoE weights in the JAX package's mixtral
    random_float_params layout (per layer input_ln, qkv, o, post_ln, router
    and the lists experts_gate_up, experts_down; all f32), drawn in
    random_quantized_params's order from the same seeded generator, so that
    quantize_params of them is random_quantized_params(seed, args) (the
    embedding and lm_head are bf16 values, drawn in bf16 there)."""
    assert args.num_experts > 0, "Mixtral params are MoE layers (num_experts > 0)"
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    E, V, NE = args.hidden_size, args.vocab_size, args.num_experts
    full = {n: f for n, (f, _) in args.linear_shapes().items()}

    def randn(shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device, dtype=dtype)
                * scale).to(torch.float32)

    def ones():
        return torch.ones((E,), dtype=torch.float32, device=device)

    layers = []
    for _ in range(args.num_layers):
        layer = dict(input_ln=ones(), qkv=randn(full["qkv"]), o=randn(full["o"]),
                     post_ln=ones(), router=randn((E, NE)),
                     experts_gate_up=[], experts_down=[])
        for _ in range(NE):
            layer["experts_gate_up"].append(randn(full["gate_up"]))
            layer["experts_down"].append(randn(full["down"]))
        layers.append(layer)
    embed = randn((V, E), torch.bfloat16)
    return dict(embed=embed, layers=layers, final_ln=ones(),
                lm_head=randn((E, V), torch.bfloat16))


def quantize_params(float_params: dict, args: llama.LlamaArgs,
                    device="cuda", rank: int = 0) -> llama.LlamaParams:
    """Quantize float weights (the JAX package's mixtral.random_float_params
    dict: per layer qkv, o, router and the lists experts_gate_up,
    experts_down of [K, N] arrays) into the serving format; at
    tp_size > 1, rank `rank`'s shards."""
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

    layers = _stacked_moe_layers(args, device, weight_of,
                                 lambda li: t(fl[li]["router"]), rank)
    layers = layers._replace(
        input_ln=torch.stack([t(x["input_ln"]) for x in fl]),
        post_ln=torch.stack([t(x["post_ln"]) for x in fl]),
    )
    return llama.LlamaParams(
        embed=t(float_params["embed"], torch.bfloat16),
        layers=layers,
        final_ln=t(float_params["final_ln"]),
        lm_head=llama.make_lm_head(
            tpmod.shard_vocab(t(float_params["lm_head"]), args, rank), args.quant),
    )


def load_float_params_from_hf(model_dir: str, args: llama.LlamaArgs) -> dict:
    """HF Mixtral weights -> the float param dict quantize_params takes
    ([in, out] layout, CPU tensors in the stored dtype):
    self_attn.{q,k,v,o}_proj, block_sparse_moe.gate (the router) and
    block_sparse_moe.experts.{e}.{w1 gate, w3 up, w2 down}."""
    from qserve_tpu_torch.models.loader import _layer_name
    from qserve_tpu_torch.utils.weight_utils import hf_model_weights_iterator

    L, NE = args.num_layers, args.num_experts
    layers = [dict() for _ in range(L)]
    qkv_parts = [dict() for _ in range(L)]
    w13 = [[dict() for _ in range(NE)] for _ in range(L)]
    top = {}
    attn = {
        "input_layernorm.weight": ("input_ln", False),
        "post_attention_layernorm.weight": ("post_ln", False),
        "self_attn.o_proj.weight": ("o", True),
        "block_sparse_moe.gate.weight": ("router", True),
    }
    for name, w in hf_model_weights_iterator(model_dir):
        if name == "model.embed_tokens.weight":
            top["embed"] = w
        elif name == "model.norm.weight":
            top["final_ln"] = w
        elif name == "lm_head.weight":
            top["lm_head"] = w.T
        elif (hit := _layer_name(name)) is not None:
            li, sub, parts = hit
            if sub in attn:
                key, transpose = attn[sub]
                layers[li][key] = w.T if transpose else w
            elif sub in ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                         "self_attn.v_proj.weight"):
                qkv_parts[li][sub[len("self_attn.")]] = w.T
            elif sub.startswith("block_sparse_moe.experts."):
                w13[li][int(parts[5])][parts[6]] = w.T

    for li in range(L):
        qp = qkv_parts[li]
        layers[li]["qkv"] = torch.cat([qp["q"], qp["k"], qp["v"]], dim=1)
        layers[li]["experts_gate_up"] = [
            torch.cat([w13[li][e]["w1"], w13[li][e]["w3"]], dim=1) for e in range(NE)
        ]
        layers[li]["experts_down"] = [w13[li][e]["w2"] for e in range(NE)]
    if "lm_head" not in top:
        top["lm_head"] = top["embed"].T
    return dict(embed=top["embed"], layers=layers,
                final_ln=top["final_ln"], lm_head=top["lm_head"])
