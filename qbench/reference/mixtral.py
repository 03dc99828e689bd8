"""Plain f32 reference of Mixtral: the dense Mistral reference
(qbench/reference/mistral.py) with its FFN a sparse MoE block: softmax
routing over the experts, the top-k renormalised, each routed token's
SwiGLU expert at W4A8, weighted and summed. The router takes the f32
input; its weight is the bf16 value the benchmark made."""

from __future__ import annotations

import torch

from qbench.reference import mistral
from qbench.reference.qoq_frozen import dequant_w4_per_channel


class Reference(mistral.Reference):
    def ffn(self, x, layer, li: int):
        sz = self.sz
        probs = torch.softmax(x @ layer["router"].float(), dim=-1)
        topv, topi = torch.topk(probs, sz.top_k, dim=-1)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        xq = self._qa(x)
        out = torch.zeros_like(x)
        gate_up, down = layer["experts_gate_up"], layer["experts_down"]
        for e in range(sz.experts):
            rows, slot = (topi == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            g, u = (xq[rows] @ dequant_w4_per_channel(gate_up[e])).chunk(2, dim=-1)
            d = self._qa(torch.nn.functional.silu(g) * u) @ dequant_w4_per_channel(down[e])
            out.index_add_(0, rows, topv[rows, slot][:, None] * d)
        return out
