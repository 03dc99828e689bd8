"""Move the JAX package's parameters into the port.

`params_from_numpy` takes the JAX package's LlamaParams after the caller has
mapped every leaf to numpy (e.g. `jax.tree.map(np.asarray, params)`), and
returns the port's LlamaParams. It reads fields by name only, so it imports
neither JAX nor the JAX package; bf16 leaves (numpy's ml_dtypes bfloat16)
cross as their raw 16-bit patterns. `vila_params_from_numpy` does the same
for a VILA model (tower, projector, LLM) and `vila_args_from_jax` rebuilds
the JAX package's VilaArgs as the port's, its compute dtypes mapped by
`torch_dtype`. `tp_shard_from_jax` cuts the global arrays of the JAX
package's quantize_params_tp into one rank's params by their
PartitionSpecs.
"""

from __future__ import annotations

import numpy as np
import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.layers import linear as lin
from qserve_tpu_torch.models import clip, llama, mm_projector, vila
from qserve_tpu_torch.utils.utils import resolve_device


def tensor_from_numpy(x, device) -> torch.Tensor:
    """numpy array (bf16 included) -> torch tensor on device, same bits."""
    x = np.array(x, order="C")  # a writable copy: torch keeps no read-only views
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def params_from_numpy(tree, device="cuda") -> llama.LlamaParams:
    """JAX LlamaParams with numpy leaves and stacked [L, ...] layers (the
    JAX package's scan_layers=True form) -> the port's LlamaParams. Each
    linear keeps its flavor (per-channel or per-group W4, W8, W16) and the
    lm_head its form (bf16 or W8); layers with a `router` are MoE layers,
    their experts' linears stacked [L, NE, ...]."""
    device = resolve_device(device)

    def t(x):
        return tensor_from_numpy(x, device)

    def linear(p):
        """One linear flavor, told by its field names."""
        if hasattr(p, "s1_szero"):
            return lin.W4ChnLinear(t(p.qweight), t(p.s1_scale), t(p.s1_szero))
        if hasattr(p, "s2_scale"):
            return lin.W4GrpLinear(
                t(p.qweight), t(p.s2_scale), t(p.s2_zero), t(p.s1_scale)
            )
        if hasattr(p, "qweight"):
            return lin.W8Linear(t(p.qweight), t(p.scale))
        return lin.W16Linear(t(p.weight))

    layers = tree.layers
    if not hasattr(layers, "input_ln"):  # a tuple of per-layer params
        raise ValueError("stacked layers expected (scan_layers=True)")
    fields = dict(
        input_ln=t(layers.input_ln),
        qkv=linear(layers.qkv),
        o=linear(layers.o),
        post_ln=t(layers.post_ln),
        gate_up=linear(layers.gate_up),
        down=linear(layers.down),
    )
    if hasattr(layers, "router"):  # MoE: experts' linears are [L, NE, ...]
        layers = llama.MoELayerParams(router=t(layers.router), **fields)
    else:
        layers = llama.LlamaLayerParams(**fields)
    return llama.LlamaParams(
        embed=t(tree.embed),
        layers=layers,
        final_ln=t(tree.final_ln),
        lm_head=(linear(tree.lm_head) if hasattr(tree.lm_head, "qweight")
                 else t(tree.lm_head)),
    )


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype, or jnp.bfloat16 / np.float32 as the JAX package's args
    hold them, as the torch dtype of the same name."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[np.dtype(dtype).name]


def _fields(obj, cls, **override) -> dict:
    """obj's dataclass fields that cls has too, by name, with overrides."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)}
    out = {k: v for k, v in vars(obj).items() if k in names}
    out.update(override)
    return out


def vila_args_from_jax(jargs) -> vila.VilaArgs:
    """The JAX package's VilaArgs (read by field name) as the port's."""
    v, p, m = jargs.vision, jargs.projector, jargs.llm
    quant = QuantSpec(**_fields(m.quant, QuantSpec))
    return vila.VilaArgs(
        llm=llama.LlamaArgs(**_fields(m, llama.LlamaArgs, quant=quant,
                                      logit_dtype=torch.float32)),
        vision=clip.VisionArgs(**_fields(
            v, clip.VisionArgs, compute_dtype=torch_dtype(v.compute_dtype))),
        projector=mm_projector.ProjectorArgs(**_fields(
            p, mm_projector.ProjectorArgs, compute_dtype=torch_dtype(p.compute_dtype))),
    )


def vila_params_from_numpy(tree, device="cuda") -> vila.VilaParams:
    """JAX VilaParams with numpy leaves (vision layers stacked [L, ...], the
    LLM as `params_from_numpy` takes it) -> the port's VilaParams. Every
    tower and projector leaf keeps its dtype (the JAX package's f32
    weights), so the port's tower computes the JAX package's mixed
    bf16-by-f32 products."""
    device = resolve_device(device)

    def t(x):
        return None if x is None else tensor_from_numpy(x, device)

    v, p = tree.vision, tree.projector
    layers = clip.VisionLayerParams(*(t(getattr(v.layers, f))
                                      for f in clip.VisionLayerParams._fields))
    vision = clip.VisionParams(
        patch_w=t(v.patch_w), patch_b=t(v.patch_b), class_embed=t(v.class_embed),
        pos_embed=t(v.pos_embed), pre_ln_scale=t(v.pre_ln_scale),
        pre_ln_bias=t(v.pre_ln_bias), layers=layers,
    )
    projector = mm_projector.ProjectorParams(
        weights=tuple(t(w) for w in p.weights), biases=tuple(t(b) for b in p.biases))
    return vila.VilaParams(vision=vision, projector=projector,
                           llm=params_from_numpy(tree.llm, device))


def _is_spec(s) -> bool:
    """A jax.sharding.PartitionSpec (a tuple of axis names or None), told by
    its class name."""
    return type(s).__name__ == "PartitionSpec"


def tp_shard_from_jax(global_params, specs, rank: int, tp: int,
                      device="cuda") -> llama.LlamaParams:
    """The JAX package's quantize_params_tp output (global arrays, numpy
    leaves, stacked layers) and its PartitionSpec tree -> rank `rank`'s
    LlamaParams of the port: every axis whose spec names the mesh axis "tp"
    is cut into tp equal blocks and block `rank` kept, as the mesh's
    shard_map hands it to device `rank` of the tp axis."""

    def cut(x, spec):
        x = np.asarray(x)
        for i, name in enumerate(tuple(spec)):
            if name == "tp":
                n = x.shape[i] // tp
                x = np.take(x, np.arange(rank * n, (rank + 1) * n), axis=i)
        return x

    def walk(x, spec):
        if _is_spec(spec):
            return cut(x, spec)
        items = [walk(a, b) for a, b in zip(x, spec)]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)

    return params_from_numpy(walk(global_params, specs), device)
