"""Plain f32 forward of Mellum2-12B-A2.5B (model_type "mellum"), written from
its published config.json alone, for the port's tests.

The block, layer by layer (Mixtral's, with a window and a RoPE per layer):

    x = RMSNorm(h); q, k, v = x Wqkv (GQA: num_attention_heads query heads
    over num_key_value_heads kv heads of head_dim)
    q, k rotated (rotate-half) by the RoPE of the layer's type in
    `rope_parameters`: "sliding_attention" plain at its rope_theta,
    "full_attention" YaRN (Hugging Face's `_compute_yarn_parameters`, truncate
    on), cos and sin both times `attention_factor`
    softmax(q k^T / sqrt(head_dim)) v, causal; a "sliding_attention" layer
    sees only the last `sliding_window` keys (key > query - window)
    h = h + attn Wo; x = RMSNorm(h)
    router: softmax(x Wr) over num_experts, the top num_experts_per_tok
    renormalised (norm_topk_prob); h = h + sum_j w_j SwiGLU_e(j)(x)
    logits = RMSNorm(h) Wlm

Departures from the published model: no MTP head (config.json has no key
for one) and no QK-norm (it declares none); both are assumptions until a
checkpoint is in the repository.

For a comparison with a quantized program, `act_quant` is applied to the
input of every linear but the router and the lm_head (the W4A8 product's
activations), and `kv_quant` to a key or value that a query reads from an
earlier step than its own (`segments`: the step each position was computed
in), as a KV cache holds it. Weights are taken as given (pass the program's
dequantized ones). Every product is f32 with TF32 off.

Imports nothing of the port, of qbench/ or of JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def yarn_inv_freq(dim: int, base: float, p: dict):
    """(inv_freq [dim / 2], attention factor) of rope_type "yarn"."""
    factor = float(p["factor"])
    orig = float(p["original_max_position_embeddings"])
    beta_fast, beta_slow = float(p.get("beta_fast") or 32), float(p.get("beta_slow") or 1)

    def correction_dim(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    inv_extrapolation = 1.0 / pos_freqs
    inv_interpolation = 1.0 / (factor * pos_freqs)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    inv_freq = inv_interpolation * ramp + inv_extrapolation * (1 - ramp)
    att = p.get("attention_factor")
    if att is None:
        att = 0.1 * math.log(factor) + 1.0
    return inv_freq, float(att)


def rope_of(dim: int, p: dict):
    """(inv_freq, cos/sin factor) of one `rope_parameters` entry."""
    kind = p.get("rope_type", "default")
    base = float(p["rope_theta"])
    if kind == "yarn":
        return yarn_inv_freq(dim, base, p)
    if kind != "default":
        raise ValueError(kind)
    return 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim), 1.0


def rotate(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor, att: float):
    """x [S, H, D] rotated at positions pos [S] (rotate-half)."""
    ang = pos.to(torch.float32)[:, None] * inv_freq[None, :]
    c, s = (torch.cos(ang) * att)[:, None, :], (torch.sin(ang) * att)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * _f32(w)


def attend(q, k, v, window: Optional[int], seg, kv_quant):
    """q [S, Hq, D], k, v [S, Hkv, D]; causal over one sequence, a key from
    an earlier step than the query's read through kv_quant."""
    S, Hq, D = q.shape
    rep = Hq // k.shape[1]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    pos = torch.arange(S)
    vis = pos[None, :] <= pos[:, None]
    if window is not None:
        vis = vis & (pos[None, :] > pos[:, None] - window)
    same = seg[:, None] == seg[None, :]
    kq, vq = kv_quant(k), kv_quant(v)
    s_exact = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    s_cache = torch.einsum("qhd,khd->hqk", q, kq) / math.sqrt(D)
    s = torch.where(same[None], s_exact, s_cache).masked_fill(~vis[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p_exact = torch.where(same[None], p, torch.zeros_like(p))
    return (torch.einsum("hqk,khd->qhd", p_exact, v)
            + torch.einsum("hqk,khd->qhd", p - p_exact, vq))


def moe(x, layer, cfg, aq):
    probs = torch.softmax(x @ _f32(layer["router"]), dim=-1)
    topv, topi = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob", True):
        topv = topv / topv.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        rows, slot = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        g, u = (aq(x[rows]) @ _f32(layer["experts_gate_up"][e])).chunk(2, dim=-1)
        d = aq(torch.nn.functional.silu(g) * u) @ _f32(layer["experts_down"][e])
        out.index_add_(0, rows, topv[rows, slot][:, None] * d)
    return out


@torch.no_grad()
def forward(params: dict, cfg: dict, ids, segments=None,
            act_quant: Optional[Callable] = None,
            kv_quant: Optional[Callable] = None) -> torch.Tensor:
    """Logits f32 [S, vocab] of one sequence of ids [S]."""
    aq = act_quant or (lambda x: x)
    kq = kv_quant or (lambda x: x)
    ids = torch.as_tensor(ids, dtype=torch.int64)
    S = ids.shape[0]
    seg = torch.zeros(S, dtype=torch.int64) if segments is None else torch.as_tensor(segments)
    pos = torch.arange(S)
    Hq, Hkv, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps = float(cfg["rms_norm_eps"])
    ropes = {t: rope_of(D, p) for t, p in cfg["rope_parameters"].items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        h = _f32(params["embed"])[ids]
        for li, layer in enumerate(params["layers"]):
            kind = cfg["layer_types"][li]
            window = cfg["sliding_window"] if kind == "sliding_attention" else None
            x = rms(h, layer["input_ln"], eps)
            q, k, v = (aq(x) @ _f32(layer["qkv"])).split([Hq * D, Hkv * D, Hkv * D], dim=-1)
            inv_freq, att = ropes[kind]
            q = rotate(q.reshape(S, Hq, D), pos, inv_freq, att)
            k = rotate(k.reshape(S, Hkv, D), pos, inv_freq, att)
            o = attend(q, k, v.reshape(S, Hkv, D), window, seg, kq)
            h = h + aq(o.reshape(S, Hq * D)) @ _f32(layer["o"])
            h = h + moe(rms(h, layer["post_ln"], eps), layer, cfg, aq)
        return rms(h, params["final_ln"], eps) @ _f32(params["lm_head"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
