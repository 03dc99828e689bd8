"""ViT vision towers (CLIP / SigLIP style) for the VLM pipeline
(qserve_tpu/models/clip.py).

The tower returns llava's CLIPVisionTower features: hidden_states
[feature_layer] with the class token dropped. Patch embedding is an
unfold + matmul (stride == kernel), the blocks are pre-LN transformer
layers. The arithmetic is the JAX package's:

  * a matmul multiplies in the compute dtype with an f32 result, adds the
    bias in f32, then casts to the compute dtype (`_mm`);
  * LayerNorm and the activations run in f32 and cast back;
  * attention takes f32 q/k/v, f32 scores and an f32 softmax, through
    scaled_dot_product_attention (the memory-efficient kernel on the card:
    no [B, H, T, T] score tensor is written).

The tower was XLA in the JAX package, not Pallas: it is library PyTorch
here on every device.

Parameters built here (`random_params`, `params_from_hf_state`) keep the
matmul weights in `compute_dtype` (bf16 by default: the card's bf16 tensor
cores) and everything else in f32. The JAX package keeps every weight as
stored (f32) and multiplies the bf16 activation by the f32 weight; a
tower given the JAX package's f32 weights (convert/from_jax.py) computes
exactly that.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qserve_tpu_torch.utils.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class VisionArgs:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    image_size: int
    patch_size: int
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    use_class_token: bool = True  # CLIP yes, SigLIP no
    use_pre_layernorm: bool = True  # CLIP yes, SigLIP no
    hidden_act: str = "quick_gelu"  # CLIP; SigLIP = "gelu_pytanh"
    # llava-style feature selection: hidden_states[feature_layer], patches only
    feature_layer: int = -2
    compute_dtype: Any = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_hf_config(cfg: dict) -> "VisionArgs":
        model_type = cfg.get("model_type", "clip_vision_model")
        siglip = "siglip" in model_type
        return VisionArgs(
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            image_size=cfg["image_size"],
            patch_size=cfg["patch_size"],
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-6 if siglip else 1e-5),
            use_class_token=not siglip,
            use_pre_layernorm=not siglip,
            hidden_act="gelu_pytanh" if siglip else "quick_gelu",
        )


class VisionLayerParams(NamedTuple):
    """Stacked over layers: every field has a leading [L] dim."""

    ln1_scale: torch.Tensor  # f32 [L, E]
    ln1_bias: torch.Tensor
    qkv_w: torch.Tensor  # [L, E, 3E]
    qkv_b: torch.Tensor  # f32 [L, 3E]
    out_w: torch.Tensor  # [L, E, E]
    out_b: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor
    fc1_w: torch.Tensor  # [L, E, I]
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor  # [L, I, E]
    fc2_b: torch.Tensor


class VisionParams(NamedTuple):
    patch_w: torch.Tensor  # [C*P*P, E] (torch conv flattened (c, ph, pw))
    patch_b: Optional[torch.Tensor]  # f32 [E] (SigLIP has a bias; CLIP none)
    class_embed: Optional[torch.Tensor]  # f32 [E] or None
    pos_embed: torch.Tensor  # f32 [n_pos, E]
    pre_ln_scale: Optional[torch.Tensor]
    pre_ln_bias: Optional[torch.Tensor]
    layers: VisionLayerParams


def _ln(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _act(x, kind: str):
    xf = x.to(torch.float32)
    if kind == "quick_gelu":
        y = xf * torch.sigmoid(1.702 * xf)
    elif kind == "gelu_pytanh":
        y = F.gelu(xf, approximate="tanh")
    else:
        y = F.gelu(xf)
    return y.to(x.dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] times w [K, N] with an f32 result: in bf16 on the card's
    tensor cores when both are bf16, else in f32 from the exact upcasts (a
    bf16 activation times an f32 weight is the JAX package's mixed
    product)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2.to(torch.float32), w.to(torch.float32))
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _mm(x, w, b=None):
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b
    return y.to(x.dtype)


def _attend(q, k, v):
    """f32 [B, H, T, D] each -> f32 [B, H, T, D]; softmax(q k^T / sqrt(D)) v."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


def _layer(h, lp: VisionLayerParams, args: VisionArgs):
    B, T, E = h.shape
    Hh, D = args.num_heads, args.head_dim
    x = _ln(h, lp.ln1_scale, lp.ln1_bias, args.layer_norm_eps)
    qkv = _mm(x, lp.qkv_w, lp.qkv_b)  # [B, T, 3E]
    q, k, v = (t.reshape(B, T, Hh, D).transpose(1, 2).to(torch.float32)
               for t in qkv.split(E, dim=-1))
    attn = _attend(q, k, v).transpose(1, 2).reshape(B, T, E).to(h.dtype)
    h = h + _mm(attn, lp.out_w, lp.out_b)
    x = _ln(h, lp.ln2_scale, lp.ln2_bias, args.layer_norm_eps)
    x = _act(_mm(x, lp.fc1_w, lp.fc1_b), args.hidden_act)
    return h + _mm(x, lp.fc2_w, lp.fc2_b)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, nH*nW, C*P*P] with torch-conv (c, ph, pw) order.
    Pixels past the last whole patch are dropped, as the stride-P conv of
    the HF towers drops them (SigLIP-so400m: 384 = 27 x 14 + 6). The JAX
    package's patchify reshapes without cropping and raises there."""
    B, C, H, W = images.shape
    nh, nw = H // patch, W // patch
    x = images[:, :, : nh * patch, : nw * patch].reshape(B, C, nh, patch, nw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, nh, nw, C, P, P]
    return x.reshape(B, nh * nw, C * patch * patch)


def forward_features(
    params: VisionParams, images: torch.Tensor, args: VisionArgs
) -> torch.Tensor:
    """[B, C, H, W] float -> patch features [B, num_patches, E] in
    compute_dtype: hidden_states[feature_layer] with the class token
    dropped (llava clip_encoder.py 'patch' select)."""
    B = images.shape[0]
    dt = args.compute_dtype
    x = patchify(images.to(torch.float32), args.patch_size).to(dt)
    h = _mm(x, params.patch_w.to(dt), params.patch_b)
    if args.use_class_token:
        cls = params.class_embed.to(dt)[None, None, :].expand(B, 1, args.hidden_size)
        h = torch.cat([cls, h], dim=1)
    h = h + params.pos_embed.to(dt)[None]
    if args.use_pre_layernorm:
        h = _ln(h, params.pre_ln_scale, params.pre_ln_bias, args.layer_norm_eps)

    # hidden_states[k] = embeddings after k layers; feature_layer=-2 runs
    # all but the last layer (HF returns L+1 hidden states)
    n_run = args.num_layers + 1 + args.feature_layer
    assert 0 <= n_run <= args.num_layers
    for li in range(n_run):  # views of the stacked weights, no copy
        h = _layer(h, VisionLayerParams(*(t[li] for t in params.layers)), args)
    if args.use_class_token:
        h = h[:, 1:]
    return h


# ---------------------------------------------------------------------------
# Weight loading (HF CLIPVisionModel / SiglipVisionModel state dicts)
# ---------------------------------------------------------------------------


def state_tensor(v) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v))


def params_from_hf_state(state: dict, args: VisionArgs, device="cuda") -> VisionParams:
    """VisionParams from a HF vision-tower state dict (torch tensors or
    numpy arrays), with or without the 'vision_model.' /
    'vision_tower.vision_model.' prefix; CLIP's 'pre_layrnorm' (sic) or
    'pre_layernorm'. Matmul weights in compute_dtype, the rest in f32."""
    device = resolve_device(device)
    dt = args.compute_dtype

    def get(key):
        for pre in ("", "vision_model.", "vision_tower.vision_model."):
            if pre + key in state:
                return state_tensor(state[pre + key])
        raise KeyError(key)

    def f32(key):
        return get(key).to(device=device, dtype=torch.float32)

    def weight(key):  # HF [out, in] -> [in, out]
        return get(key).T.to(device=device, dtype=dt).contiguous()

    def has(key):
        try:
            get(key)
        except KeyError:
            return False
        return True

    E = args.hidden_size
    pw = get("embeddings.patch_embedding.weight")  # [E, C, P, P]
    patch_w = pw.reshape(E, -1).T.to(device=device, dtype=dt).contiguous()
    patch_b = (f32("embeddings.patch_embedding.bias")
               if has("embeddings.patch_embedding.bias") else None)
    class_embed = None
    if args.use_class_token:
        class_embed = f32("embeddings.class_embedding").reshape(E)
    pos = f32("embeddings.position_embedding.weight")
    pre_s = pre_b = None
    if args.use_pre_layernorm:
        name = "pre_layrnorm" if has("pre_layrnorm.weight") else "pre_layernorm"
        pre_s, pre_b = f32(f"{name}.weight"), f32(f"{name}.bias")

    layers = []
    for li in range(args.num_layers):
        p = f"encoder.layers.{li}."
        attn = p + "self_attn."
        layers.append(VisionLayerParams(
            ln1_scale=f32(p + "layer_norm1.weight"),
            ln1_bias=f32(p + "layer_norm1.bias"),
            qkv_w=torch.cat([weight(attn + f"{n}_proj.weight") for n in "qkv"], dim=1),
            qkv_b=torch.cat([f32(attn + f"{n}_proj.bias") for n in "qkv"]),
            out_w=weight(attn + "out_proj.weight"),
            out_b=f32(attn + "out_proj.bias"),
            ln2_scale=f32(p + "layer_norm2.weight"),
            ln2_bias=f32(p + "layer_norm2.bias"),
            fc1_w=weight(p + "mlp.fc1.weight"),
            fc1_b=f32(p + "mlp.fc1.bias"),
            fc2_w=weight(p + "mlp.fc2.weight"),
            fc2_b=f32(p + "mlp.fc2.bias"),
        ))
    return VisionParams(
        patch_w=patch_w, patch_b=patch_b, class_embed=class_embed, pos_embed=pos,
        pre_ln_scale=pre_s, pre_ln_bias=pre_b,
        layers=VisionLayerParams(*(torch.stack(xs) for xs in zip(*layers))),
    )


def random_params(
    gen: torch.Generator, args: VisionArgs, device="cuda", scale: float = 0.02
) -> VisionParams:
    """Random weights (N(0, scale), drawn in f32 from `gen` on `device`):
    the JAX package's random tower, with unit norms and zero biases (a
    patch bias only without a class token, as SigLIP has)."""
    device = resolve_device(device)
    E, I, L = args.hidden_size, args.intermediate_size, args.num_layers
    P, C = args.patch_size, args.num_channels
    n_pos = args.num_patches + (1 if args.use_class_token else 0)
    dt = args.compute_dtype

    def init(*shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    layers = VisionLayerParams(
        ln1_scale=const(1.0, L, E), ln1_bias=const(0.0, L, E),
        qkv_w=init(L, E, 3 * E, dtype=dt), qkv_b=const(0.0, L, 3 * E),
        out_w=init(L, E, E, dtype=dt), out_b=const(0.0, L, E),
        ln2_scale=const(1.0, L, E), ln2_bias=const(0.0, L, E),
        fc1_w=init(L, E, I, dtype=dt), fc1_b=const(0.0, L, I),
        fc2_w=init(L, I, E, dtype=dt), fc2_b=const(0.0, L, E),
    )
    return VisionParams(
        patch_w=init(C * P * P, E, dtype=dt),
        patch_b=None if args.use_class_token else const(0.0, E),
        class_embed=init(E) if args.use_class_token else None,
        pos_embed=init(n_pos, E),
        pre_ln_scale=const(1.0, E) if args.use_pre_layernorm else None,
        pre_ln_bias=const(0.0, E) if args.use_pre_layernorm else None,
        layers=layers,
    )
