"""Activation-aware quantization scale optimization (qserve_tpu/quant/optimize.py).

The reference's published accuracy (ref README.md:378-387) assumes
DeepCompressor-optimized scales (ref scripts/ckpt_converter/quant_utils.py:
96-138 consumes them). This module is the in-framework equivalent: given a
float checkpoint and a calibration token stream it produces a
*mathematically equivalent* float model whose quantized form has lower error
than plain RTN, via three transforms:

  1. **SmoothQuant folding** (per linear input): per-input-channel scales
     s_k = amax(x_k)^alpha / amax(w_k)^(1-alpha) move activation outliers
     into the weights. Each fold is exact in float:
       - qkv input     -> folded into input_layernorm weight
       - gate_up input -> folded into post_attention_layernorm weight
       - down input    -> folded into the up-projection's output columns
       - o input       -> folded into the v-projection's output columns,
                          shared across the query heads of each KV group
                          (attention output is a convex combination of V).
  2. **SmoothAttention**: lambda_k = amax(K_k)^alpha of K after RoPE,
     shared across each rotation pair (d, d + D/2) so the pre-RoPE fold
     W_k /= lambda, W_q *= lambda commutes with the rotation; scores Q.K^T
     are invariant and the K cache sees a flattened channel range.
  3. **Weight clip search** (AWQ-style): per output channel (per group for
     g128) the shrunken quantization range minimizing the activation-
     weighted error sum_k E[x_k^2] * (w_kj - Q(w_kj))^2.

All transforms act on the float parameter dict (the input of
models.llama.quantize_params); the output feeds the unchanged RTN
quantizer, so the packed format and the serving kernels are untouched.

Calibration runs on the device of `device` (the card unless the caller
passes "cpu"). It packs each batch of B windows into one token stream with
one segment id per window, so one prefill attention launch a layer (K3 on
the card) serves the batch, where the JAX package vmaps over the windows;
the products are bf16 library matmuls (XLA in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qserve_tpu_torch.kernels import attention
from qserve_tpu_torch.layers import rope
from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.quant import qoq
from qserve_tpu_torch.utils.utils import resolve_device

logger = init_logger(__name__)


class LayerStats(NamedTuple):
    """Per-layer calibration statistics (absmax and mean-square are over all
    calibration tokens; shapes are per input channel of each linear)."""

    qkv_in_amax: torch.Tensor  # [E]
    qkv_in_ms: torch.Tensor  # [E]
    o_in_amax: torch.Tensor  # [Hq*D]
    o_in_ms: torch.Tensor  # [Hq*D]
    gate_up_in_amax: torch.Tensor  # [E]
    gate_up_in_ms: torch.Tensor  # [E]
    down_in_amax: torch.Tensor  # [I]
    down_in_ms: torch.Tensor  # [I]
    k_rope_amax: torch.Tensor  # [Hkv, D] post-RoPE K channel absmax


def _as_tensor(x, device, dtype, copy=False) -> torch.Tensor:
    """A tensor (or a numpy / JAX-exported array) on device in dtype."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype, copy=copy)


def _bf16_weights(float_params: dict, device) -> dict:
    """The embedding and every layer's linears in bf16 on `device` (norm
    weights in f32), made once per calibrate call."""
    bf16, f32 = torch.bfloat16, torch.float32
    layers = [dict(input_ln=_as_tensor(fl["input_ln"], device, f32),
                   post_ln=_as_tensor(fl["post_ln"], device, f32),
                   **{n: _as_tensor(fl[n], device, bf16)
                      for n in ("qkv", "o", "gate_up", "down")})
              for fl in float_params["layers"]]
    return dict(embed=_as_tensor(float_params["embed"], device, bf16), layers=layers)


def _stats_forward(weights: dict, args, token_ids: torch.Tensor) -> List[LayerStats]:
    """Float forward over one [B, T] batch collecting per-layer stats.

    models.llama.reference_forward_float's math (dense layers only) with
    bf16 matmuls; stats are reduced in f32. The B windows run as one packed
    stream of B*T tokens, window b under segment id b + 1."""
    B, T = token_ids.shape
    dev = token_ids.device
    h = weights["embed"][token_ids.reshape(-1).long()]  # [B*T, E] bf16
    positions = torch.arange(T, dtype=torch.int32, device=dev).repeat(B)
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)
    seg = torch.arange(1, B + 1, dtype=torch.int32, device=dev).repeat_interleave(T)

    def rms(x, w):
        xf = x.to(torch.float32)
        v = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(v + args.rms_eps) * w).to(torch.bfloat16)

    def amax_ms(x):  # [B*T, C] -> ([C], [C])
        xf = x.to(torch.float32)
        return xf.abs().amax(dim=0), (xf * xf).mean(dim=0)

    stats: List[LayerStats] = []
    for fl in weights["layers"]:
        x = rms(h, fl["input_ln"])
        qkv_amax, qkv_ms = amax_ms(x)
        q, k, v = (x @ fl["qkv"]).split([args.q_size, args.kv_size, args.kv_size], dim=-1)
        q = rope.apply_rope(q.reshape(B * T, args.num_heads, args.head_dim), cos, sin)
        k = rope.apply_rope(k.reshape(B * T, args.num_kv_heads, args.head_dim), cos, sin)
        v = v.reshape(B * T, args.num_kv_heads, args.head_dim)
        k_amax = k.to(torch.float32).abs().amax(dim=0)  # [Hkv, D]
        attn = attention.prefill_attention(q, k, v, seg).reshape(B * T, args.q_size)
        o_amax, o_ms = amax_ms(attn)
        h = h + (attn.to(torch.bfloat16) @ fl["o"]).to(h.dtype)
        x = rms(h, fl["post_ln"])
        gu_amax, gu_ms = amax_ms(x)
        g, u = (x @ fl["gate_up"]).chunk(2, dim=-1)
        y = F.silu(g.to(torch.float32)).to(torch.bfloat16) * u
        dn_amax, dn_ms = amax_ms(y)
        h = h + (y @ fl["down"]).to(h.dtype)
        stats.append(LayerStats(
            qkv_in_amax=qkv_amax, qkv_in_ms=qkv_ms,
            o_in_amax=o_amax, o_in_ms=o_ms,
            gate_up_in_amax=gu_amax, gate_up_in_ms=gu_ms,
            down_in_amax=dn_amax, down_in_ms=dn_ms,
            k_rope_amax=k_amax,
        ))
    return stats


def calibrate(
    float_params: dict, args, windows: np.ndarray, batch: int = 8, device="cuda"
) -> List[LayerStats]:
    """Run calibration over token windows [n, T] on `device`; merge stats
    (max of the absmaxes, mean of the batches' mean-squares)."""
    if len(windows) and int(windows.max()) >= args.vocab_size:
        # the JAX package's gather clamps such an id to the last row
        raise ValueError(
            f"calibration ids reach {int(windows.max())}, past the vocabulary of "
            f"{args.vocab_size} (load_calib_windows' BOS 256 needs more than 256 ids)")
    dev = resolve_device(device)
    weights = _bf16_weights(float_params, dev)
    merged: Optional[List[LayerStats]] = None
    n_batches = 0
    for i in range(0, len(windows), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(windows[i : i + batch], np.int32))
        st = _stats_forward(weights, args, chunk.to(dev))
        if merged is None:
            merged = st
        else:
            merged = [
                LayerStats(*(torch.maximum(a, b) if name.endswith("amax") else a + b
                             for name, a, b in zip(LayerStats._fields, m, s)))
                for m, s in zip(merged, st)
            ]
        n_batches += 1
    assert merged is not None, "no calibration windows"
    inv = 1.0 / n_batches
    return [
        s._replace(
            qkv_in_ms=s.qkv_in_ms * inv,
            o_in_ms=s.o_in_ms * inv,
            gate_up_in_ms=s.gate_up_in_ms * inv,
            down_in_ms=s.down_in_ms * inv,
        )
        for s in merged
    ]


# ---------------------------------------------------------------------------
# Smoothing folds
# ---------------------------------------------------------------------------


def _balance_scale(act_amax: torch.Tensor, w_in_amax: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """SmoothQuant balance: s = amax(x)^a / amax(w)^(1-a), sanitized."""
    a = torch.clamp(act_amax.to(torch.float32), min=1e-5)
    w = torch.clamp(w_in_amax.to(torch.float32), min=1e-5)
    s = a**alpha / w ** (1.0 - alpha)
    return torch.clamp(s, 1e-4, 1e4)


def _w_in_amax(w: torch.Tensor) -> torch.Tensor:
    """Per-input-channel absmax of a [K, N] weight."""
    return w.to(torch.float32).abs().amax(dim=1)


def smooth_layer(
    fl: Dict[str, torch.Tensor],
    st: LayerStats,
    args,
    alpha: float = 0.5,
    alpha_attn: float = 0.5,
    smooth_attn: bool = True,
    smooth_v: bool = True,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Fold smoothing scales into one layer's float params, in f32 on the
    device of the stats.

    Returns (new_layer_params, scales) where scales holds the applied
    per-input-channel s for each linear (activation stats divide by these:
    the post-fold activation is x / s)."""
    Hq, Hkv, D = args.num_heads, args.num_kv_heads, args.head_dim
    rep = Hq // Hkv
    dev = st.qkv_in_amax.device

    def f32(x):  # a fresh f32 copy on the stats' device
        return _as_tensor(x, dev, torch.float32, copy=True)

    qkv, o = f32(fl["qkv"]), f32(fl["o"])
    gate_up, down = f32(fl["gate_up"]), f32(fl["down"])
    input_ln, post_ln = f32(fl["input_ln"]), f32(fl["post_ln"])
    I = down.shape[0]

    # --- qkv input (fold into input_layernorm) ---
    s_qkv = _balance_scale(st.qkv_in_amax, _w_in_amax(qkv), alpha)
    input_ln = input_ln / s_qkv
    qkv = qkv * s_qkv[:, None]

    # --- gate_up input (fold into post_attention_layernorm) ---
    s_gu = _balance_scale(st.gate_up_in_amax, _w_in_amax(gate_up), alpha)
    post_ln = post_ln / s_gu
    gate_up = gate_up * s_gu[:, None]

    # --- down input (fold into the up projection's output columns) ---
    s_dn = _balance_scale(st.down_in_amax, _w_in_amax(down), alpha)
    gate_up[:, I:] /= s_dn[None, :]
    down = down * s_dn[:, None]

    # --- o input (fold into v columns, shared across each KV group) ---
    if smooth_v:
        # share across the rep query heads attending one KV head
        ov_amax = st.o_in_amax.reshape(Hkv, rep, D).amax(dim=1)  # [Hkv, D]
        ov_w = _w_in_amax(o).reshape(Hkv, rep, D).amax(dim=1)
        s_v = _balance_scale(ov_amax.reshape(-1), ov_w.reshape(-1), alpha).reshape(Hkv, D)
        s_o = s_v.repeat_interleave(rep, dim=0).reshape(Hq * D)  # to q heads
        v_off = (Hq + Hkv) * D
        qkv[:, v_off:] /= s_v.reshape(-1)[None, :]
        o = o * s_o[:, None]
    else:
        s_o = torch.ones((Hq * D,), dtype=torch.float32, device=dev)

    # --- SmoothAttention: flatten K's post-RoPE channel range ---
    if smooth_attn:
        lam = torch.clamp(st.k_rope_amax.to(torch.float32), min=1e-5) ** alpha_attn
        # share across RoPE rotation pairs (d, d + D/2) so the pre-RoPE fold
        # commutes with the rotation
        half = D // 2
        lam_pair = torch.maximum(lam[:, :half], lam[:, half:])
        lam = torch.cat([lam_pair, lam_pair], dim=1)  # [Hkv, D]
        # geometric mean 1: scores are invariant either way; this keeps the
        # q/k weight magnitudes near their originals
        lam = lam / torch.exp(torch.log(lam).mean())
        lam = torch.clamp(lam, 1e-2, 1e2)
        k_off = Hq * D
        qkv[:, k_off : k_off + Hkv * D] /= lam.reshape(-1)[None, :]
        lam_q = lam.repeat_interleave(rep, dim=0).reshape(-1)  # [Hq*D]
        qkv[:, : Hq * D] *= lam_q[None, :]

    out = dict(fl)
    out.update(
        input_ln=input_ln, qkv=qkv, o=o, post_ln=post_ln,
        gate_up=gate_up, down=down,
    )
    scales = dict(qkv=s_qkv, o=s_o, gate_up=s_gu, down=s_dn)
    return out, scales


# ---------------------------------------------------------------------------
# Weight clip search
# ---------------------------------------------------------------------------


def clip_ratios(n_grid: int, min_ratio: float, device="cpu") -> torch.Tensor:
    """The grid 1.0 -> min_ratio of n_grid f32 ratios, as the JAX package's
    jnp.linspace gives it under jit: step = i * (1 / div), ratio =
    (1 - step) + min_ratio * step, the last ratio min_ratio itself."""
    f32 = dict(dtype=torch.float32, device=device)
    if n_grid == 1:
        return torch.ones((1,), **f32)
    div = n_grid - 1
    step = torch.arange(div, **f32) * torch.tensor(1.0 / div, **f32)
    head = (1 - step) + torch.tensor(min_ratio, **f32) * step
    return torch.cat([head, torch.tensor([min_ratio], **f32)])


def clip_weight(
    w: torch.Tensor,  # [K, N] float
    act_ms: torch.Tensor,  # [K] E[x_k^2] of the (post-fold) input
    bits: int = 4,
    group_size: int = -1,
    n_grid: int = 16,
    min_ratio: float = 0.5,
) -> torch.Tensor:
    """AWQ-style clip: shrink each quantization range by the grid ratio that
    minimizes sum_k E[x_k^2] (w - Q(w))^2; returns the *clipped float* w
    (feeding it to the RTN quantizer reproduces the clipped-range quant,
    since RTN recomputes min/max from the clipped values). Plain PyTorch on
    the device of w; one ratio's error at a time (at gate_up [4096, 28672]
    one is ~470 MB of f32), the first of equal errors kept, as argmin."""
    K, N = w.shape
    wf = w.to(torch.float32)
    qmax = (1 << bits) - 1
    G = K // group_size if group_size > 0 else 1
    wg = wf.reshape(G, K // G, N)
    amg = act_ms.to(device=w.device, dtype=torch.float32).reshape(G, K // G, 1)
    gmax = wg.amax(dim=1, keepdim=True)  # [G, 1, N]
    gmin = wg.amin(dim=1, keepdim=True)

    best_err = best = None
    for r in clip_ratios(n_grid, min_ratio, w.device):
        cmax, cmin = gmax * r, gmin * r
        scale = qoq._div(torch.clamp(cmax - cmin, min=1e-8), qmax)
        zero = torch.clamp(torch.round(-cmin / scale), 0, qmax)
        q = torch.clamp(torch.round(wg / scale) + zero, 0, qmax)
        deq = (q - zero) * scale
        err = (amg * (wg - deq) ** 2).sum(dim=1)  # [G, N]
        if best is None:
            best_err, best = err, torch.full_like(err, float(r))
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best = torch.where(better, r, best)
    cmax = gmax * best[:, None, :]
    cmin = gmin * best[:, None, :]
    return torch.clamp(wg, cmin, cmax).reshape(K, N).to(w.dtype)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def optimize_float_params(
    float_params: dict,
    args,
    calib_windows: np.ndarray,  # [n, T] int32 token windows
    alpha: float = 0.5,
    alpha_attn: float = 0.5,
    clip: bool = True,
    clip_grid: int = 16,
    smooth_attn: bool = True,
    smooth_v: bool = True,
    calib_batch: int = 8,
    device="cuda",
) -> dict:
    """Full pipeline on `device`: calibrate -> smooth folds -> clip search.

    Returns a new float parameter dict (layer weights f32 CPU tensors),
    mathematically equivalent to the input in float, whose RTN quantization
    (models.llama.quantize_params) carries the optimized scales. Dense Llama
    layers only: MoE args raise NotImplementedError."""
    if getattr(args, "num_experts", 0):
        raise NotImplementedError("scale optimization targets dense layers")
    logger.info(
        "calibrating on %d windows x %d tokens", len(calib_windows),
        calib_windows.shape[1],
    )
    stats = calibrate(float_params, args, calib_windows, batch=calib_batch,
                      device=device)

    do_clip = clip and args.quant.weight_bits == 4
    gs = args.quant.group_size
    new_layers = []
    for li, (fl, st) in enumerate(zip(float_params["layers"], stats)):
        nl, scales = smooth_layer(
            fl, st, args, alpha=alpha, alpha_attn=alpha_attn,
            smooth_attn=smooth_attn, smooth_v=smooth_v,
        )
        if do_clip:
            # post-fold activation mean-squares: x' = x / s => E[x'^2] = E/s^2
            for name, ms in (
                ("qkv", st.qkv_in_ms), ("o", st.o_in_ms),
                ("gate_up", st.gate_up_in_ms), ("down", st.down_in_ms),
            ):
                ms_f = ms.to(torch.float32) / (scales[name] ** 2)
                nl[name] = clip_weight(nl[name], ms_f, bits=4, group_size=gs,
                                       n_grid=clip_grid)
        new_layers.append({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                           for k, v in nl.items()})
        logger.info("optimized layer %d/%d", li + 1, len(stats))
    out = dict(float_params)
    out["layers"] = new_layers
    return out


def load_calib_windows(
    corpus_dir: str, n_windows: int = 32, seqlen: int = 512, bos: int = 256
) -> np.ndarray:
    """Calibration windows from the local byte corpus (train split; the
    held-out val split stays untouched for PPL eval). The draw is the JAX
    package's (np.random.RandomState(0)), so both pick the same windows."""
    import os

    data = np.fromfile(os.path.join(corpus_dir, "train.bin"), np.uint8)
    rng = np.random.RandomState(0)
    starts = rng.randint(0, len(data) - seqlen - 1, size=n_windows)
    rows = np.stack([data[s : s + seqlen - 1].astype(np.int32) for s in starts])
    return np.concatenate(
        [np.full((n_windows, 1), bos, np.int32), rows], axis=1
    )
