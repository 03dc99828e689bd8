"""Move the JAX package's parameters into the port.

`params_from_numpy` takes the JAX package's LlamaParams after the caller has
mapped every leaf to numpy (e.g. `jax.tree.map(np.asarray, params)`), and
returns the port's LlamaParams. It reads fields by name only, so it imports
neither JAX nor the JAX package; bf16 leaves (numpy's ml_dtypes bfloat16)
cross as their raw 16-bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from qserve_tpu_torch.layers import linear as lin
from qserve_tpu_torch.models import llama
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
