"""Model construction and weight loading (qserve_tpu/models/loader.py).

Two load paths, as in the JAX package (and `load_vlm_model` for a VILA
or LLaVA directory, whose LLM loads through them):
  * a float Hugging Face checkpoint (safetensors, .bin or .pt), quantized
    at load time on the target device with the QoQ round-to-nearest math of
    quant/qoq.py (Mixtral too: its experts quantize one by one);
  * a packed QoQ checkpoint (convert/checkpoint_converter.py), written by
    this package or by the JAX package, for dense Llama models.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.utils.weight_utils import hf_model_weights_iterator

logger = init_logger(__name__)

LLAMA_ARCHS = {
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "YiForCausalLM",
}
MIXTRAL_ARCHS = {"MixtralForCausalLM"}


def load_hf_config_dict(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def args_from_config_dict(cfg: dict, quant: QuantSpec) -> llama.LlamaArgs:
    return llama.LlamaArgs.from_config_dict(cfg, quant)


def _layer_name(name: str):
    """'model.layers.{li}.{sub}' -> (li, sub, parts), else None."""
    if not name.startswith("model.layers."):
        return None
    parts = name.split(".")
    return int(parts[2]), ".".join(parts[3:]), parts


def load_float_params_from_hf(model_dir: str, args: llama.LlamaArgs) -> dict:
    """Collect HF llama weights into the float param dict ([in, out] layout,
    CPU tensors in the stored dtype): fused qkv and gate_up, and the
    embedding's transpose as lm_head when the checkpoint has none."""
    L = args.num_layers
    layers: list = [dict() for _ in range(L)]
    top: Dict[str, torch.Tensor] = {}
    qkv_parts: list = [dict() for _ in range(L)]
    gu_parts: list = [dict() for _ in range(L)]
    plain = {
        "input_layernorm.weight": (layers, "input_ln", False),
        "post_attention_layernorm.weight": (layers, "post_ln", False),
        "self_attn.q_proj.weight": (qkv_parts, "q", True),
        "self_attn.k_proj.weight": (qkv_parts, "k", True),
        "self_attn.v_proj.weight": (qkv_parts, "v", True),
        "self_attn.o_proj.weight": (layers, "o", True),
        "mlp.gate_proj.weight": (gu_parts, "gate", True),
        "mlp.up_proj.weight": (gu_parts, "up", True),
        "mlp.down_proj.weight": (layers, "down", True),
    }
    for name, w in hf_model_weights_iterator(model_dir):
        if "rotary_emb" in name:
            continue
        if name == "model.embed_tokens.weight":
            top["embed"] = w
        elif name == "model.norm.weight":
            top["final_ln"] = w
        elif name == "lm_head.weight":
            top["lm_head"] = w.T
        elif (hit := _layer_name(name)) is not None:
            li, sub, _ = hit
            if sub in plain:  # biases are not read (the llama family has none)
                dst, key, transpose = plain[sub]
                dst[li][key] = w.T if transpose else w

    for li in range(L):
        qp, gp = qkv_parts[li], gu_parts[li]
        layers[li]["qkv"] = torch.cat([qp["q"], qp["k"], qp["v"]], dim=1)
        layers[li]["gate_up"] = torch.cat([gp["gate"], gp["up"]], dim=1)
    if "lm_head" not in top:  # tied embeddings
        top["lm_head"] = top["embed"].T
    return dict(
        embed=top["embed"],
        layers=layers,
        final_ln=top["final_ln"],
        lm_head=top["lm_head"],
    )


def load_vlm_model(model_dir: str, quant: QuantSpec, quant_path: Optional[str] = None,
                   device="cuda"):
    """A VILA/LLaVA checkpoint: vision tower + projector + quantized LLM, as
    (VilaArgs, VilaParams) on `device`. Two layouts, as in the JAX package:
      * VILA: <dir>/{llm, vision_tower, mm_projector}/, each HF-style;
      * LLaVA: one HF directory whose state dict holds model.mm_projector.*
        and whose config's mm_vision_tower names a local directory.
    The tower's matmul weights load in its compute dtype (bf16)."""
    from qserve_tpu_torch.models import clip, mm_projector, vila

    cfg = load_hf_config_dict(model_dir)
    llm_dir = model_dir
    if os.path.isdir(os.path.join(model_dir, "llm")):
        llm_dir = os.path.join(model_dir, "llm")
    largs, lparams = load_model(llm_dir, quant, quant_path=quant_path, device=device)

    vt_dir = os.path.join(model_dir, "vision_tower")
    if not os.path.isdir(vt_dir):
        vt_name = cfg.get("mm_vision_tower") or cfg.get("vision_tower")
        if not (vt_name and os.path.isdir(vt_name)):
            raise FileNotFoundError(
                f"vision tower not found: {vt_name!r} (needs a local path)")
        vt_dir = vt_name
    vt_cfg = load_hf_config_dict(vt_dir)
    vargs = clip.VisionArgs.from_hf_config(vt_cfg.get("vision_config", vt_cfg))
    vparams = clip.params_from_hf_state(
        dict(hf_model_weights_iterator(vt_dir)), vargs, device=device)

    proj_type = cfg.get("mm_projector_type", cfg.get("mm_projector", "linear"))
    if not isinstance(proj_type, str) or os.path.isdir(str(proj_type)):
        proj_type = "mlp_downsample"
    pargs = mm_projector.ProjectorArgs(
        kind=proj_type, vision_hidden=vargs.hidden_size,
        llm_hidden=largs.hidden_size, grid=vargs.grid,
    )
    proj_dir = os.path.join(model_dir, "mm_projector")
    proj_state = dict(hf_model_weights_iterator(
        proj_dir if os.path.isdir(proj_dir) else model_dir))
    pparams = mm_projector.params_from_hf_state(proj_state, pargs, device=device)

    args = vila.VilaArgs(llm=largs, vision=vargs, projector=pargs)
    logger.info(
        "Loaded VLM: tower %dpx/%d grid %d, projector %s (%d tok/img), LLM %s",
        vargs.image_size, vargs.patch_size, vargs.grid, proj_type,
        args.tokens_per_image, quant.precision,
    )
    return args, vila.VilaParams(vision=vparams, projector=pparams, llm=lparams)


def load_model(
    model_dir: str,
    quant: QuantSpec,
    quant_path: Optional[str] = None,
    device="cuda",
):
    """(args, params) on `device`. A float checkpoint is quantized there;
    a packed one (quant_path, dense Llama only) is read and moved there.
    Mixtral always self-quantizes from its HF weights and ignores
    quant_path, as the JAX package does."""
    cfg = load_hf_config_dict(model_dir)
    archs = set(cfg.get("architectures", []))
    if archs & MIXTRAL_ARCHS:
        from qserve_tpu_torch.models import mixtral

        args = mixtral.args_from_config_dict(cfg, quant)
        fp = mixtral.load_float_params_from_hf(model_dir, args)
        params = mixtral.quantize_params(fp, args, device=device)
        logger.info("Self-quantized Mixtral (%d experts) to %s",
                    args.num_experts, quant.precision)
        return args, params
    if archs and not (archs & LLAMA_ARCHS):
        raise NotImplementedError(f"unsupported architectures {archs}")
    args = args_from_config_dict(cfg, quant)
    if quant_path:
        from qserve_tpu_torch.convert.checkpoint_converter import load_packed_checkpoint

        params = load_packed_checkpoint(quant_path, args, device=device)
        logger.info("Loaded packed QoQ checkpoint from %s", quant_path)
    else:
        fp = load_float_params_from_hf(model_dir, args)
        params = llama.quantize_params(fp, args, device=device)
        logger.info(
            "Self-quantized %s to %s (group_size=%d)",
            model_dir, quant.precision, quant.group_size,
        )
    return args, params
