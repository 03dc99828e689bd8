"""Mellum (model_type "mellum"; Mellum2-12B-A2.5B): Mixtral's decoder
(qbench/families/mixtral.py) with a window or a full layer each
(`layer_types`: "sliding_attention" attends over the last `sliding_window`
keys, "full_attention" over all) and each layer type's RoPE
(`rope_parameters`: plain on the window layers, YaRN on the full ones), and
in every layer a sparse-MoE FFN: the router's softmax over `num_experts`
SwiGLU experts of width `moe_intermediate_size`, the top
`num_experts_per_tok` renormalised. `intermediate_size` belongs to no layer.

Weights: Mixtral's tags and layout (qbench/families/mixtral.py).
"""

from __future__ import annotations

from qbench.families import Program, mistral, mixtral, quant_spec
from qbench.reference import mellum as reference
from qbench.roofline import model, paged_attention

float_params = mixtral.float_params
gemm_bound_s = mixtral.gemm_bound_s
params_per_token_layer = mixtral.params_per_token_layer


class Sizes(mistral.Sizes):
    def __init__(self, cfg: dict) -> None:
        super().__init__(cfg)
        self.inter = int(cfg["moe_intermediate_size"])
        self.experts = int(cfg["num_experts"])
        self.top_k = int(cfg["num_experts_per_tok"])
        window = cfg["sliding_window"] if cfg.get("use_sliding_window", True) else None
        kinds = cfg["layer_types"]
        if set(kinds) - {"sliding_attention", "full_attention"}:
            raise ValueError(f"unknown layer types in {sorted(set(kinds))}")
        # each layer's window (None: all keys) and its RoPE's parameters
        self.windows = [window if k == "sliding_attention" else None for k in kinds]
        self.ropes = [cfg["rope_parameters"][k] for k in kinds]
        self.window = None  # no window every layer shares


def sizes(cfg: dict) -> Sizes:
    return Sizes(cfg)


def program(cfg: dict) -> Program:
    """The port's MoE args with a window and a RoPE per layer. A program
    that reads the configuration otherwise (a per-layer window it does not
    give, another expert count or width) cannot serve this model: it is
    refused here, before any weight is made."""
    from qserve_tpu_torch.models import mixtral as port_mixtral

    sz = sizes(cfg)
    args = port_mixtral.args_from_config_dict(cfg, quant_spec(cfg))
    windows = getattr(args, "layer_windows", None)
    if (windows is None or list(windows) != sz.windows or args.num_experts != sz.experts
            or args.intermediate_size != sz.inter or args.moe_top_k != sz.top_k):
        raise RuntimeError("this program does not serve model_type 'mellum': it reads "
                           "no window a layer, or other experts")
    return Program(args, port_mixtral.quantize_params,
                   dict(sliding_window=None, layer_windows=tuple(windows)))


class Reference(reference.Reference):
    def __init__(self, maker, act_bits=None) -> None:
        super().__init__(float_params(maker), maker.sizes, act_bits)


# ---- operations and bytes --------------------------------------------------

def step_ops(step, sz) -> float:
    """Mixtral's count, each layer's attention over its own window."""
    keys = sum(model.attended_keys(step, w) for w in sz.windows)
    return model.step_ops(step, sz, params_per_token_layer(sz), keys)


def paged_attn_bound_s(step, sz) -> float:
    """The least time of one step's K4 launches, all layers: a decode row
    reads its whole context in a full layer, its last `window` keys (the
    current one among them) in a window layer."""
    return sum(paged_attention.bound_s([c if w is None else min(c, w) for c in step.decode_ctx],
                                       sz, 1)
               for w in sz.windows)
