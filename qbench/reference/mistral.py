"""Plain f32 reference of the dense Mistral decoder: the published forward
(RMSNorm, GQA attention with rotate-half RoPE and the sliding window,
SwiGLU) at the precision the configuration states, W4A8KV4 with a bf16
lm_head, computed in f32 with TF32 off.

It imports nothing of the program. Its weights are the float ones the
family's `float_params` lays out from the benchmark's maker, quantized
again here by the frozen copy of the QoQ arithmetic (qoq_frozen.py). Layer
by layer, over all the sampled sequences at once, attention in blocks of
query rows, so that it fits.

What the precision means, position by position, and where it departs from
the published description:

  * every linear's input is quantized per token to int8 (symmetric) and its
    weight per output channel to uint4 (asymmetric): the W4A8 product;
  * a key or value read from the cache is its KV4 value (per token and
    head, asymmetric, bf16 scale and zero); one computed in the same step
    as the query is exact. Which positions shared a step (a prompt's
    chunks; each decoded token alone) is the program's scheduling, read
    from its outputs: with a quantized cache attention depends on it;
  * the lm_head takes f32 inputs; its weight is the bf16 value the
    benchmark made. Everything else is f32: the program keeps the residual
    stream, the GEMM outputs, the attention operands and the RoPE'd q and k
    in bf16, which is the gap the comparison allows for;
  * weights are random (seeded); RMSNorm weights are not 1.

A family whose layers differ in their attention window or RoPE, or whose
FFN differs, overrides `window`, `rope` or `ffn`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from qbench.reference.qoq_frozen import (
    dequant_w4_per_channel,
    fake_quant_act,
    fake_quant_kv,
    kv_scale_dtype,
)
from qbench.reference.served import Served, exact_f32


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """Rotate-half RoPE of x [S, H, D] at positions pos [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Reference:
    """`params`: the family's float weights (embed, layers, final_ln,
    lm_head); `sz`: its Sizes."""

    def __init__(self, params, sz, act_bits: Optional[int] = None, q_block: int = 512) -> None:
        if (sz.weight_bits, sz.group_size, sz.lm_head_bits) != (4, -1, 16) or sz.act_bits != 8:
            raise NotImplementedError(
                "the reference holds W4A8 per-channel with a bf16 lm_head only")
        self.params, self.sz = params, sz
        self.act_bits = act_bits or sz.act_bits
        self.q_block = q_block
        self.kv_dtype = kv_scale_dtype(sz.kv_heads)

    def _qa(self, x):
        return fake_quant_act(x, self.act_bits)

    def window(self, li: int) -> Optional[int]:
        """The keys layer li attends over: the last this many, or all."""
        return self.sz.window

    def rope(self, x, pos, li: int):
        return rope(x, pos, self.sz.rope_theta)

    def ffn(self, x, layer, li: int):
        g, u = (self._qa(x) @ dequant_w4_per_channel(layer["gate_up"])).chunk(2, dim=-1)
        return self._qa(torch.nn.functional.silu(g) * u) @ dequant_w4_per_channel(layer["down"])

    def _attend(self, q, k, v, seg, pos, window):
        """One sequence: q [S, Hq, D], k, v [S, Hkv, D] f32 (RoPE'd)."""
        sz = self.sz
        S, Hq, D = q.shape
        rep = Hq // k.shape[1]
        kq = fake_quant_kv(k, sz.kv_bits, self.kv_dtype).repeat_interleave(rep, dim=1)
        vq = fake_quant_kv(v, sz.kv_bits, self.kv_dtype).repeat_interleave(rep, dim=1)
        ke, ve = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        sm = 1.0 / (D ** 0.5)
        out = torch.empty_like(q)
        for b0 in range(0, S, self.q_block):
            b1 = min(S, b0 + self.q_block)
            qb = q[b0:b1]
            se = torch.einsum("bhd,shd->hbs", qb, ke[:b1]) * sm
            sq = torch.einsum("bhd,shd->hbs", qb, kq[:b1]) * sm
            same = seg[b0:b1, None] == seg[None, :b1]
            vis = pos[None, :b1] <= pos[b0:b1, None]
            if window is not None:
                vis = vis & (pos[None, :b1] > pos[b0:b1, None] - window)
            s = torch.where(same[None], se, sq)
            s = torch.where(vis[None], s, torch.full_like(s, float("-inf")))
            p = torch.softmax(s, dim=-1)
            pe = torch.where(same[None], p, torch.zeros_like(p))
            out[b0:b1] = (torch.einsum("hbs,shd->bhd", pe, ve[:b1])
                          + torch.einsum("hbs,shd->bhd", p - pe, vq[:b1]))
        return out

    @torch.no_grad()
    def served_logits(self, seqs: List[Served]) -> List[torch.Tensor]:
        sz, prm = self.sz, self.params
        dev = prm["embed"].device
        with exact_f32():
            ids = torch.from_numpy(np.concatenate(
                [np.concatenate([s.prompt, s.tokens[:-1]]) for s in seqs]).astype(np.int64)).to(dev)
            lens = [s.length for s in seqs]
            pos = torch.cat([torch.arange(n, device=dev) for n in lens])
            segs = [torch.from_numpy(s.segments()).to(dev) for s in seqs]
            bounds = np.concatenate([[0], np.cumsum(lens)])
            h = prm["embed"][ids].float()
            D = sz.head_dim
            for li in range(sz.layers):
                layer = prm["layers"][li]
                x = rms(h, layer["input_ln"], sz.eps)
                qkv = self._qa(x) @ dequant_w4_per_channel(layer["qkv"])
                q, k, v = qkv.split([sz.heads * D, sz.kv_heads * D, sz.kv_heads * D], dim=-1)
                q = self.rope(q.reshape(-1, sz.heads, D), pos, li)
                k = self.rope(k.reshape(-1, sz.kv_heads, D), pos, li)
                v = v.reshape(-1, sz.kv_heads, D)
                window = self.window(li)
                attn = torch.empty_like(q)
                for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
                    attn[a:b] = self._attend(q[a:b], k[a:b], v[a:b], segs[i], pos[a:b], window)
                o = dequant_w4_per_channel(layer["o"])
                h = h + self._qa(attn.reshape(-1, sz.heads * D)) @ o
                x = rms(h, layer["post_ln"], sz.eps)
                h = h + self.ffn(x, layer, li)
            rows = torch.cat([torch.arange(b - s.scored, b, device=dev)
                              for s, b in zip(seqs, bounds[1:])])
            hs = rms(h[rows], prm["final_ln"], sz.eps)
            del h
            logits = hs @ prm["lm_head"].float()
        return list(torch.split(logits, [s.scored for s in seqs]))
