"""The dense Mistral decoder (model_type "mistral"; Mistral-7B): every layer
the same GQA attention, over one sliding window or none, with one RoPE
theta, and a SwiGLU FFN. The interface: qbench/families/__init__.py.

Weights: each tensor N(0, std^2) by its tags (layer, name, expert; the
expert is None here), [K, N] linears, qkv = q ++ k ++ v columns, gate_up =
gate ++ up columns, embed [V, E], lm_head [E, V]; RMSNorm weights by
(layer, name) and ("final_ln",).
"""

from __future__ import annotations

from qbench import weights
from qbench.families import Program, quant_spec
from qbench.reference import mistral as reference
from qbench.roofline import gemm, model, paged_attention
from qbench.weights import LazyMap, LazySeq

LAYER_KEYS = ("input_ln", "qkv", "o", "post_ln", "gate_up", "down")


class Sizes(weights.Sizes):
    def __init__(self, cfg: dict) -> None:
        super().__init__(cfg)
        self.inter = cfg["intermediate_size"]
        self.rope_theta = float(cfg.get("rope_theta", 10000.0))
        self.window = cfg.get("sliding_window")  # every layer's

    def linear_shapes(self) -> dict:
        E, I, D = self.hidden, self.inter, self.head_dim
        return dict(qkv=(E, self.qkv_out), o=(self.heads * D, E),
                    gate_up=(E, 2 * I), down=(I, E))


def sizes(cfg: dict) -> Sizes:
    return Sizes(cfg)


# ---- weights ---------------------------------------------------------------

def layer_tensor(maker, li: int, name: str, expert=None):
    """A layer's RMSNorm weight or [K, N] linear, by name."""
    sz = maker.sizes
    if name in ("input_ln", "post_ln"):
        return maker.norm(sz.hidden, li, name)
    return maker.normal(sz.linear_shapes()[name], maker.std["layer"], li, name, expert)


def params_of(maker, layer) -> dict:
    """embed, the layers (layer(li) makes layer li's mapping when it is
    read), final_ln and lm_head."""
    sz, std = maker.sizes, maker.std
    return dict(embed=maker.normal((sz.vocab, sz.hidden), std["embed"], "embed"),
                layers=LazySeq(sz.layers, layer),
                final_ln=maker.norm(sz.hidden, "final_ln"),
                lm_head=maker.normal((sz.hidden, sz.vocab), std["lm_head"], "lm_head"))


def float_params(maker) -> dict:
    return params_of(maker, lambda li: LazyMap(
        LAYER_KEYS, lambda name: layer_tensor(maker, li, name)))


# ---- the program and the reference -----------------------------------------

def program(cfg: dict) -> Program:
    from qserve_tpu_torch.models import llama

    args = llama.LlamaArgs.from_config_dict(cfg, quant_spec(cfg))
    return Program(args, llama.quantize_params, dict(sliding_window=args.sliding_window))


class Reference(reference.Reference):
    def __init__(self, maker, act_bits=None) -> None:
        super().__init__(float_params(maker), maker.sizes, act_bits)


# ---- operations and bytes --------------------------------------------------

def params_per_token_layer(sz) -> int:
    shapes = sz.linear_shapes()
    return sum(k * n for k, n in (shapes["qkv"], shapes["o"], shapes["gate_up"], shapes["down"]))


def one_window_ops(step, sz, active_params: int) -> float:
    """The step's operations, every layer attending over `sz.window`."""
    return model.step_ops(step, sz, active_params,
                          sz.layers * model.attended_keys(step, sz.window))


def step_ops(step, sz) -> float:
    return one_window_ops(step, sz, params_per_token_layer(sz))


def attn_gemm_bound_s(t: int, sz) -> float:
    """One layer's qkv and o launches over t live rows."""
    shapes = sz.linear_shapes()
    return sum(gemm.dense_bound_s(t, shapes[n]) for n in ("qkv", "o"))


def gemm_bound_s(step, sz) -> float:
    """The least time of one step's W4A8 GEMM launches, all layers."""
    t = gemm.live_tokens(step)
    if t == 0:
        return 0.0
    shapes = sz.linear_shapes()
    per_layer = attn_gemm_bound_s(t, sz)
    per_layer += sum(gemm.dense_bound_s(t, shapes[n]) for n in ("gate_up", "down"))
    return sz.layers * per_layer


def paged_attn_bound_s(step, sz) -> float:
    """The least time of one step's K4 launches, all layers: every decode
    row's whole context in each."""
    return paged_attention.bound_s(step.decode_ctx, sz, sz.layers)
