"""Mixtral (model_type "mixtral"; Mixtral-8x7B): Mistral's decoder
(qbench/families/mistral.py) with a sparse-MoE FFN in every layer, the
router's softmax over `num_local_experts` SwiGLU experts of width
`intermediate_size`, the top `num_experts_per_tok` renormalised.

Weights: Mistral's, but for the FFN: the router [E, NE] by (layer,
"router"), and each expert's gate_up and down by (layer, name, expert).
"""

from __future__ import annotations

from qbench.families import Program, mistral, quant_spec
from qbench.reference import mixtral as reference
from qbench.roofline import gemm
from qbench.weights import LazyMap, LazySeq

LAYER_KEYS = ("input_ln", "qkv", "o", "post_ln", "router", "experts_gate_up", "experts_down")

paged_attn_bound_s = mistral.paged_attn_bound_s


class Sizes(mistral.Sizes):
    def __init__(self, cfg: dict) -> None:
        super().__init__(cfg)
        self.experts = int(cfg["num_local_experts"])
        self.top_k = int(cfg["num_experts_per_tok"])


def sizes(cfg: dict) -> Sizes:
    return Sizes(cfg)


def layer_tensor(maker, li: int, name: str):
    sz = maker.sizes
    if name == "router":
        return maker.normal((sz.hidden, sz.experts), maker.std["router"], li, "router")
    if name.startswith("experts_"):
        base = name[len("experts_"):]
        return LazySeq(sz.experts, lambda e: mistral.layer_tensor(maker, li, base, e))
    return mistral.layer_tensor(maker, li, name)


def float_params(maker) -> dict:
    return mistral.params_of(maker, lambda li: LazyMap(
        LAYER_KEYS, lambda name: layer_tensor(maker, li, name)))


def program(cfg: dict) -> Program:
    from qserve_tpu_torch.models import mixtral

    args = mixtral.args_from_config_dict(cfg, quant_spec(cfg))
    return Program(args, mixtral.quantize_params, dict(sliding_window=args.sliding_window))


class Reference(reference.Reference):
    def __init__(self, maker, act_bits=None) -> None:
        super().__init__(float_params(maker), maker.sizes, act_bits)


def params_per_token_layer(sz) -> int:
    shapes = sz.linear_shapes()
    attn = sum(k * n for k, n in (shapes["qkv"], shapes["o"]))
    expert = sum(k * n for k, n in (shapes["gate_up"], shapes["down"]))
    return attn + sz.hidden * sz.experts + sz.top_k * expert


def step_ops(step, sz) -> float:
    return mistral.one_window_ops(step, sz, params_per_token_layer(sz))


def gemm_bound_s(step, sz) -> float:
    """The least time of one step's W4A8 GEMM launches, all layers: qkv and
    o over the live rows, the experts' routed over their top-k rows."""
    t = gemm.live_tokens(step)
    if t == 0:
        return 0.0
    shapes = sz.linear_shapes()
    per_layer = mistral.attn_gemm_bound_s(t, sz)
    for n in ("gate_up", "down"):
        per_layer += gemm.routed_bound_s(t, sz.experts, sz.top_k, shapes[n])
    return sz.layers * per_layer
