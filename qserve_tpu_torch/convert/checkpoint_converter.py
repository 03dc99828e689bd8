"""The packed QoQ checkpoint (qserve_tpu/convert/checkpoint_converter.py).

A directory of one `model.safetensors` and a `qserve_tpu_config.json`, in
the JAX package's format, so a checkpoint packed by either package loads in
the other bit for bit:

  * `embed` and `lm_head` bf16, `final_ln` f32;
  * every layer field stacked [L, ...]: `layers.input_ln`, `layers.post_ln`
    and `layers.{qkv,o,gate_up,down}.{kind}.{field}`, where kind is w4chn,
    w4grp, w8 or w16 and the fields are the linear's (layers/linear.py):
    [K, N] weights with W4 nibbles packed in the global half-split layout;
  * the JSON holds the model geometry, the QuantSpec and `pack_layout` 2.

The format has no router, so it holds dense Llama models only (Mixtral
loads from its Hugging Face weights). A W8 lm_head is not packed: the JAX
package's own save of one fails, so neither package can read one.

Two sources convert into it, as in the JAX package:
  * a float HF checkpoint, quantized with RTN QoQ math on the card
    (convert_hf_checkpoint), optionally after activation-aware scale
    optimization over a calibration corpus (quant/optimize.py);
  * DeepCompressor fake-quant output, model.pt + scale.pt, whose optimized
    scales are kept (convert_deepcompressor_checkpoint, on the host).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.layers import linear as lin
from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.quant import packing
from qserve_tpu_torch.utils.utils import resolve_device
from qserve_tpu_torch.utils.weight_utils import read_safetensors, write_safetensors

logger = init_logger(__name__)

# W4 nibble-packing layout version. v1 was the half-tile (PACK_TILE=512)
# layout; v2 is the global half-split layout. Checkpoints written before
# versioning carry no marker and are treated as v1 (refused): v1 bytes read
# as v2 would serve garbage.
PACK_LAYOUT_VERSION = 2

_LIN_FIELDS = {
    "w4chn": lin.W4ChnLinear._fields,
    "w4grp": lin.W4GrpLinear._fields,
    "w8": lin.W8Linear._fields,
    "w16": lin.W16Linear._fields,
}
_KIND_BY_TYPE = {
    lin.W4ChnLinear: "w4chn",
    lin.W4GrpLinear: "w4grp",
    lin.W8Linear: "w8",
    lin.W16Linear: "w16",
}
_PROJS = ("qkv", "o", "gate_up", "down")
CONFIG_NAME = "qserve_tpu_config.json"
WEIGHTS_NAME = "model.safetensors"


def _flatten_params(params: llama.LlamaParams) -> Dict[str, torch.Tensor]:
    """LlamaParams -> flat {name: tensor}; layer fields stay stacked [L, ...]."""
    if isinstance(params.layers, llama.MoELayerParams):
        raise ValueError(
            "the packed format has no router: it holds dense Llama models only"
        )
    if not isinstance(params.lm_head, torch.Tensor):
        raise NotImplementedError(
            "a W8 lm_head cannot be packed: the JAX package's save of one fails "
            "(_flatten_params stores lm_head as one array: ValueError: setting "
            "an array element with a sequence), so no packed checkpoint has one"
        )
    out = {
        "embed": params.embed,
        "final_ln": params.final_ln,
        "lm_head": params.lm_head,
    }
    layers = params.layers
    for proj in _PROJS:
        p = getattr(layers, proj)
        kind = _KIND_BY_TYPE[type(p)]
        for f in _LIN_FIELDS[kind]:
            out[f"layers.{proj}.{kind}.{f}"] = getattr(p, f)
    out["layers.input_ln"] = layers.input_ln
    out["layers.post_ln"] = layers.post_ln
    return out


def _config_meta(args: llama.LlamaArgs) -> dict:
    """The JAX package's JSON: its LlamaArgs fields (scan_layers, tp_size
    and tp_axis at their single-device values; not the run-time settings),
    the QuantSpec and the layout marker."""
    if args.layer_attn:
        raise ValueError("the packed format holds one window and RoPE for every layer")
    meta = {f.name: getattr(args, f.name) for f in dataclasses.fields(args)
            if f.name not in ("quant", "logit_dtype", "layer_attn") + llama.RUNTIME_FIELDS}
    meta.update(quant=dataclasses.asdict(args.quant), scan_layers=True,
                tp_size=1, tp_axis="tp", pack_layout=PACK_LAYOUT_VERSION)
    return meta


def save_packed_checkpoint(params: llama.LlamaParams, args: llama.LlamaArgs,
                           out_dir: str) -> int:
    """Write params (any device) as a packed checkpoint; returns the
    weight file's size in bytes."""
    flat = _flatten_params(params)
    os.makedirs(out_dir, exist_ok=True)
    nbytes = write_safetensors(flat, os.path.join(out_dir, WEIGHTS_NAME))
    with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
        json.dump(_config_meta(args), f, indent=2)
    logger.info("Saved packed checkpoint to %s", out_dir)
    return nbytes


def _check_layout(path: str) -> None:
    cfg_path = os.path.join(path, CONFIG_NAME)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            layout = json.load(f).get("pack_layout", 1)
        if layout != PACK_LAYOUT_VERSION:
            raise ValueError(
                f"Packed checkpoint at {path} uses W4 pack layout v{layout}, "
                f"but this build expects v{PACK_LAYOUT_VERSION}. Re-run the "
                "checkpoint converter against the original weights."
            )


def load_packed_checkpoint(path: str, args: llama.LlamaArgs,
                           device="cuda") -> llama.LlamaParams:
    """Read a packed checkpoint onto `device`. Each tensor must have the
    shape and dtype args' geometry and quantization give it (a checkpoint of
    another model, precision or group size raises ValueError)."""
    _check_layout(path)
    device = resolve_device(device)
    flat = read_safetensors(os.path.join(path, WEIGHTS_NAME))

    model = f"this model's {args.quant.precision} (group {args.quant.group_size})"

    def get(name, want: torch.Tensor):
        t = flat.get(name)
        if t is None:
            raise ValueError(f"packed checkpoint {path} lacks {name!r}, which {model} takes")
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(
                f"packed checkpoint {path}: {name!r} is {t.dtype} {list(t.shape)}, "
                f"{model} takes {want.dtype} {list(want.shape)}"
            )
        return t.to(device)

    # the expected shapes and dtypes, allocated nowhere
    E, I, L, V = args.hidden_size, args.intermediate_size, args.num_layers, args.vocab_size
    shapes = dict(qkv=(E, args.qkv_out), o=(args.q_size, E), gate_up=(E, 2 * I), down=(I, E))
    lins = {}
    for proj, (K, N) in shapes.items():
        want = llama.empty_linear((L,), K, N, "meta", args.quant)
        kind = _KIND_BY_TYPE[type(want)]
        lins[proj] = type(want)(*(
            get(f"layers.{proj}.{kind}.{f}", w) for f, w in zip(want._fields, want)
        ))

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    layers = llama.LlamaLayerParams(
        input_ln=get("layers.input_ln", meta((L, E), torch.float32)),
        post_ln=get("layers.post_ln", meta((L, E), torch.float32)),
        **lins,
    )
    return llama.LlamaParams(
        embed=get("embed", meta((V, E), torch.bfloat16)),
        layers=layers,
        final_ln=get("final_ln", meta((E,), torch.float32)),
        lm_head=get("lm_head", meta((E, V), torch.bfloat16)),
    )


def load_packed_config(path: str) -> llama.LlamaArgs:
    """The port's LlamaArgs from a packed checkpoint's JSON (either
    package's); the JAX package's fields without meaning here (scan_layers,
    tp_size, tp_axis, logit_dtype), its run-time settings (the port takes
    its own) and the layout marker are dropped."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        meta = json.load(f)
    quant = QuantSpec(**meta.pop("quant"))
    for k in ("scan_layers", "tp_size", "tp_axis", "logit_dtype", "pack_layout",
              *llama.RUNTIME_FIELDS):
        meta.pop(k, None)
    if meta.get("num_experts", 0) > 0:
        raise ValueError(
            f"{path}: num_experts={meta['num_experts']}, but the packed format "
            "has no router: it holds dense Llama models only (Mixtral loads "
            "from its Hugging Face weights)"
        )
    return llama.LlamaArgs(quant=quant, **meta)


def convert_hf_checkpoint(
    model_dir: str, out_dir: str, precision: str, group_size: int = -1,
    kv_zp: bool = True, calib_corpus: str | None = None,
    calib_windows: int = 32, calib_seqlen: int = 512, alpha: float = 0.5,
    device="cuda",
) -> None:
    """Quantize a local HF float checkpoint on `device` and pack it.

    With calib_corpus set (a directory holding train.bin), activation-aware
    scale optimization (quant/optimize.py: SmoothQuant / SmoothAttention
    folds and the clip search, the in-framework stand-in for the
    reference's DeepCompressor pipeline) runs on the float weights, on
    `device`, before RTN."""
    from qserve_tpu_torch.models import loader

    quant = QuantSpec.from_precision(precision, group_size, kv_zp)
    cfg = loader.load_hf_config_dict(model_dir)
    args = loader.args_from_config_dict(cfg, quant)
    fp = loader.load_float_params_from_hf(model_dir, args)
    if calib_corpus is not None:
        from qserve_tpu_torch.quant import optimize

        calib = optimize.load_calib_windows(
            calib_corpus, n_windows=calib_windows, seqlen=calib_seqlen
        )
        fp = optimize.optimize_float_params(
            fp, args, calib, alpha=alpha, alpha_attn=alpha, device=device
        )
    params = llama.quantize_params(fp, args, device=device)
    save_packed_checkpoint(params, args, out_dir)


def convert_deepcompressor_checkpoint(
    model_dir: str,
    quant_ckpt_dir: str,
    out_dir: str,
    precision: str = "w4a8kv4",
    group_size: int = -1,
    kv_zp: bool = True,
) -> None:
    """Convert DeepCompressor fake-quant output (model.pt + scale.pt), on
    the host.

    model.pt holds the fake-quantized (already rounded) float weights;
    scale.pt holds s1 (and per-group s2) scales plus zeros. Reference
    semantics (checkpoint_converter.py:81-134): integer lattice values are
    recovered by dividing the fake-quant weights by the scales and adding
    the zero point (+8 folds signed int4 into unsigned). The lattice math
    is the JAX package's, in numpy f32, so both packages write the same
    bytes; two of its behaviours are kept as they are there:
      * per group, 8 is added to every code of a tensor when any code is
        negative, and z2 is left as stored;
      * s2 is clipped to [1, 255] and stored as its uint8 bit pattern in
        the int8 carrier (200 is stored as -56 and read as 200)."""
    from qserve_tpu_torch.models import loader

    quant = QuantSpec.from_precision(precision, group_size, kv_zp)
    cfg = loader.load_hf_config_dict(model_dir)
    args = loader.args_from_config_dict(cfg, quant)

    state = torch.load(os.path.join(quant_ckpt_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    scales = torch.load(os.path.join(quant_ckpt_dir, "scale.pt"), map_location="cpu",
                        weights_only=True)

    def to_np(t):
        return t.float().numpy()

    def t(x, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x if dtype is None else x.to(dtype)

    def build_linear(prefix: str) -> lin.LinearParams:
        # fake-quant weight [OC, IC] -> our [K, N] = transpose (a torch copy,
        # multithreaded, so numpy's elementwise work runs on rows)
        w = state[f"{prefix}.weight"].float().T.contiguous().numpy()  # [K, N]
        K, N = w.shape
        s1_key = f"{prefix}.weight.scale"
        zero_key = f"{prefix}.weight.zero"
        if quant.weight_bits == 8:
            s1 = to_np(scales[s1_key]).reshape(N)
            q = np.clip(np.rint(w / s1[None, :]), -128, 127).astype(np.int8)
            return lin.W8Linear(t(q), t(s1.astype(np.float32)))
        if group_size == -1:
            s1 = to_np(scales[s1_key]).reshape(N)
            zero = to_np(scales[zero_key]).reshape(N) if zero_key in scales else (
                np.zeros(N, np.float32)
            )
            # reference folds +8: stored zero is for the signed lattice
            zero_u = zero + 8.0
            q = np.clip(np.rint(w / s1[None, :] + zero_u[None, :]), 0, 15)
            return lin.W4ChnLinear(
                qweight=packing.pack_w4(t(q, torch.int8)),
                s1_scale=t(s1.astype(np.float32)),
                s1_szero=t((s1 * zero_u).astype(np.float32)),
            )
        # per-group: level-1 float scale + level-2 integer scale/zero
        s1 = to_np(scales[s1_key]).reshape(N)  # [N]
        s2 = to_np(scales[f"{prefix}.weight.scale2"]).reshape(K // group_size, N)
        z2 = to_np(scales[zero_key]).reshape(K // group_size, N)
        w8 = w / s1[None, :]
        G = K // group_size
        wg = w8.reshape(G, group_size, N)
        q = np.rint((wg - z2[:, None, :]) / np.maximum(s2[:, None, :], 1e-8))
        q = np.clip(q + 8.0 if q.min() < 0 else q, 0, 15).astype(np.int8)
        return lin.W4GrpLinear(
            qweight=packing.pack_w4(t(q.reshape(K, N))),
            s2_scale=t(np.clip(s2, 1, 255).astype(np.int16).astype(np.int8)),
            s2_zero=t(np.clip(z2, -128, 127).astype(np.int8)),
            s1_scale=t(s1.astype(np.float32)),
        )

    layers = []
    for li in range(args.num_layers):
        pre = f"model.layers.{li}"
        layers.append(llama.LlamaLayerParams(
            input_ln=t(to_np(state[f"{pre}.input_layernorm.weight"])),
            qkv=_concat_cols(
                build_linear(f"{pre}.self_attn.q_proj"),
                build_linear(f"{pre}.self_attn.k_proj"),
                build_linear(f"{pre}.self_attn.v_proj"),
            ),
            o=build_linear(f"{pre}.self_attn.o_proj"),
            post_ln=t(to_np(state[f"{pre}.post_attention_layernorm.weight"])),
            gate_up=_concat_cols(
                build_linear(f"{pre}.mlp.gate_proj"),
                build_linear(f"{pre}.mlp.up_proj"),
            ),
            down=build_linear(f"{pre}.mlp.down_proj"),
        ))
    def stack(*xs):  # per-layer NamedTuples of tensors -> stacked [L, ...]
        if isinstance(xs[0], tuple):
            return type(xs[0])(*map(stack, *xs))
        return torch.stack(xs)

    stacked = stack(*layers)
    def bf16(name):  # rounded as the JAX package rounds f32 (RNE), in torch
        return state[name].float().to(torch.bfloat16)

    embed = bf16("model.embed_tokens.weight")
    # transposed after rounding: a bf16 copy, multithreaded
    lm_head = (bf16("lm_head.weight") if "lm_head.weight" in state else embed).T.contiguous()
    params = llama.LlamaParams(
        embed=embed, layers=stacked,
        final_ln=t(to_np(state["model.norm.weight"])), lm_head=lm_head,
    )
    save_packed_checkpoint(params, args, out_dir)


def _concat_cols(*parts: lin.LinearParams) -> lin.LinearParams:
    """Column-concat linears of the same kind (qkv / gate_up fusion)."""
    kind = type(parts[0])
    if kind is lin.W16Linear:
        return lin.W16Linear(torch.cat([p.weight for p in parts], dim=1))
    if kind is lin.W8Linear:
        return lin.W8Linear(
            qweight=torch.cat([p.qweight for p in parts], dim=1),
            scale=torch.cat([p.scale for p in parts], dim=0),
        )
    if kind is lin.W4ChnLinear:
        return lin.W4ChnLinear(
            qweight=torch.cat([p.qweight for p in parts], dim=1),
            s1_scale=torch.cat([p.s1_scale for p in parts], dim=0),
            s1_szero=torch.cat([p.s1_szero for p in parts], dim=0),
        )
    if kind is lin.W4GrpLinear:
        return lin.W4GrpLinear(
            qweight=torch.cat([p.qweight for p in parts], dim=1),
            s2_scale=torch.cat([p.s2_scale for p in parts], dim=1),
            s2_zero=torch.cat([p.s2_zero for p in parts], dim=1),
            s1_scale=torch.cat([p.s1_scale for p in parts], dim=0),
        )
    raise TypeError(kind)
