"""Plain f32 reference of the served model: the published Mistral / Mixtral
forward (RMSNorm, GQA attention with rotate-half RoPE and the sliding
window, SwiGLU, top-k softmax routing) at the precision the configuration
states, W4A8KV4 with a bf16 lm_head, computed in f32 with TF32 off.

It imports nothing of the program. Weights come from the benchmark's own
maker (qbench/weights.py) and are quantized again here by the frozen copy
of the QoQ arithmetic (qoq_frozen.py). Layer by layer, over all the sampled
sequences at once, attention in blocks of query rows, so that it fits.

What the precision means, position by position, and where it departs from
the published description:

  * every linear's input is quantized per token to int8 (symmetric) and its
    weight per output channel to uint4 (asymmetric): the W4A8 product;
  * a key or value read from the cache is its KV4 value (per token and
    head, asymmetric, bf16 scale and zero); one computed in the same step
    as the query is exact. Which positions shared a step (a prompt's
    chunks; each decoded token alone) is the program's scheduling, read
    from its outputs: with a quantized cache attention depends on it;
  * the router and the lm_head take f32 inputs; their weights are the bf16
    values the benchmark made. Everything else is f32: the program keeps
    the residual stream, the GEMM outputs, the attention operands and the
    RoPE'd q and k in bf16, which is the gap the comparison allows for;
  * weights are random (seeded); RMSNorm weights are not 1.

`served_logits` returns, for each sequence, the logits at the positions
that produced its last `scored` served tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from qbench.reference.qoq_frozen import (
    dequant_w4_per_channel,
    fake_quant_act,
    fake_quant_kv,
    kv_scale_dtype,
)


@dataclasses.dataclass
class Served:
    prompt: np.ndarray  # prompt ids
    tokens: np.ndarray  # the served tokens, in order
    chunk_ends: List[int]  # where each prompt step's span ended
    scored: int  # the last this many served tokens are judged

    @property
    def length(self) -> int:
        """Positions the forward runs over: the prompt and every served
        token but the last (which no step read)."""
        return len(self.prompt) + len(self.tokens) - 1

    def segments(self) -> np.ndarray:
        """The step of each position: a prompt chunk's positions share one,
        each decoded position has its own."""
        n, seg = len(self.prompt), np.empty(self.length, np.int64)
        start = 0
        for i, end in enumerate(self.chunk_ends):
            seg[start:end] = i
            start = end
        if start != n:
            raise ValueError(f"prompt spans end at {start}, the prompt at {n}")
        seg[n:] = len(self.chunk_ends) + np.arange(self.length - n)
        return seg


@contextlib.contextmanager
def exact_f32():
    """f32 products with TF32 off, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """Rotate-half RoPE of x [S, H, D] at positions pos [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Reference:
    def __init__(self, maker, act_bits: Optional[int] = None, q_block: int = 512) -> None:
        sz = maker.sizes
        if (sz.weight_bits, sz.group_size, sz.lm_head_bits) != (4, -1, 16) or sz.act_bits != 8:
            raise NotImplementedError(
                "the reference holds W4A8 per-channel with a bf16 lm_head only")
        self.maker, self.sz = maker, sz
        self.act_bits = act_bits or sz.act_bits
        self.q_block = q_block
        self.kv_dtype = kv_scale_dtype(sz.kv_heads)

    def _w(self, li, name, expert=None):
        return dequant_w4_per_channel(self.maker.linear(li, name, expert))

    def _qa(self, x):
        return fake_quant_act(x, self.act_bits)

    def _attend(self, q, k, v, seg, pos):
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
            if sz.window is not None:
                vis = vis & (pos[None, :b1] > pos[b0:b1, None] - sz.window)
            s = torch.where(same[None], se, sq)
            s = torch.where(vis[None], s, torch.full_like(s, float("-inf")))
            p = torch.softmax(s, dim=-1)
            pe = torch.where(same[None], p, torch.zeros_like(p))
            out[b0:b1] = (torch.einsum("hbs,shd->bhd", pe, ve[:b1])
                          + torch.einsum("hbs,shd->bhd", p - pe, vq[:b1]))
        return out

    def _moe(self, x, li):
        sz = self.sz
        probs = torch.softmax(x @ self.maker.router(li).float(), dim=-1)
        topv, topi = torch.topk(probs, sz.top_k, dim=-1)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        xq = self._qa(x)
        out = torch.zeros_like(x)
        for e in range(sz.experts):
            rows, slot = (topi == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            g, u = (xq[rows] @ self._w(li, "gate_up", e)).chunk(2, dim=-1)
            d = self._qa(torch.nn.functional.silu(g) * u) @ self._w(li, "down", e)
            out.index_add_(0, rows, topv[rows, slot][:, None] * d)
        return out

    @torch.no_grad()
    def served_logits(self, seqs: List[Served]) -> List[torch.Tensor]:
        sz, mk = self.sz, self.maker
        dev = mk.device
        with exact_f32():
            ids = torch.from_numpy(np.concatenate(
                [np.concatenate([s.prompt, s.tokens[:-1]]) for s in seqs]).astype(np.int64)).to(dev)
            lens = [s.length for s in seqs]
            pos = torch.cat([torch.arange(n, device=dev) for n in lens])
            segs = [torch.from_numpy(s.segments()).to(dev) for s in seqs]
            bounds = np.concatenate([[0], np.cumsum(lens)])
            h = mk.embed()[ids].float()
            E, D = sz.hidden, sz.head_dim
            for li in range(sz.layers):
                x = _rms(h, mk.norm(li, "input_ln"), sz.eps)
                qkv = self._qa(x) @ self._w(li, "qkv")
                q, k, v = qkv.split([sz.heads * D, sz.kv_heads * D, sz.kv_heads * D], dim=-1)
                q = _rope(q.reshape(-1, sz.heads, D), pos, sz.rope_theta)
                k = _rope(k.reshape(-1, sz.kv_heads, D), pos, sz.rope_theta)
                v = v.reshape(-1, sz.kv_heads, D)
                attn = torch.empty_like(q)
                for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
                    attn[a:b] = self._attend(q[a:b], k[a:b], v[a:b], segs[i], pos[a:b])
                h = h + self._qa(attn.reshape(-1, sz.heads * D)) @ self._w(li, "o")
                x = _rms(h, mk.norm(li, "post_ln"), sz.eps)
                if sz.experts:
                    h = h + self._moe(x, li)
                else:
                    g, u = (self._qa(x) @ self._w(li, "gate_up")).chunk(2, dim=-1)
                    h = h + self._qa(torch.nn.functional.silu(g) * u) @ self._w(li, "down")
            rows = torch.cat([torch.arange(b - s.scored, b, device=dev)
                              for s, b in zip(seqs, bounds[1:])])
            hs = _rms(h[rows], mk.final_ln(), sz.eps)
            del h
            logits = hs @ mk.lm_head().float()
        return list(torch.split(logits, [s.scored for s in seqs]))


def served_gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """How far each token's logit lies below the reference's best."""
    t = torch.as_tensor(tokens, dtype=torch.int64).to(logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]
