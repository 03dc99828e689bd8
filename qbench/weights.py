"""Float weights made from the run's seed, on the device, tensor by tensor.

Each tensor has a generator of its own, seeded from (seed, layer, name,
expert), so any tensor can be made again alone: the program quantizes
them at set-up, and the reference makes the same ones again after the
window. Layers are a lazy sequence: `layers[li][name]` makes that tensor
when it is read, so Mixtral-8x7B (about 93 GB in bf16) never exists whole.
The layout is the one `models/llama.py` and `models/mixtral.py`
`quantize_params` read: [K, N] linears, qkv = q ++ k ++ v columns, gate_up =
gate ++ up columns, embed [V, E], lm_head [E, V], router [E, NE].

Each is N(0, std^2) drawn in f32 and rounded once to bf16, the type a
checkpoint holds it in; RMSNorm weights are U(0.5, 1.5) in f32, so a path
that ignored them would show. The stds are the configuration file's
`assumed.weight_std` (keys `layer`, `embed`, `lm_head` and, with experts,
`router`); each file gives the reason for its own.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping, Sequence

import torch


def derive_seed(seed: int, *tags) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(str(int(seed) & ((1 << 64) - 1)).encode())
    for t in tags:
        h.update(b"\0" + str(t).encode())
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Sizes:
    """The widths of a configuration file, by the names the harness uses."""

    def __init__(self, cfg: dict) -> None:
        self.vocab = cfg["vocab_size"]
        self.hidden = cfg["hidden_size"]
        self.inter = cfg["intermediate_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg.get("num_key_value_heads", self.heads)
        self.head_dim = cfg.get("head_dim") or self.hidden // self.heads
        self.rope_theta = float(cfg.get("rope_theta", 10000.0))
        self.eps = float(cfg.get("rms_norm_eps", 1e-6))
        self.window = cfg.get("sliding_window")
        self.experts = int(cfg.get("num_local_experts") or 0)
        self.top_k = int(cfg.get("num_experts_per_tok") or 0)
        s = cfg["serving"]
        prec = s["precision"]
        self.weight_bits = int(prec[1:prec.index("a")])
        self.act_bits = int(prec[prec.index("a") + 1:prec.index("kv")])
        self.kv_bits = int(prec[prec.index("kv") + 2:])
        self.group_size = int(s["group_size"])
        self.kv_zero_point = bool(s["kv_zero_point"])
        self.lm_head_bits = int(s["lm_head_bits"])
        self.page = int(s["page_size"])

    @property
    def qkv_out(self) -> int:
        return (self.heads + 2 * self.kv_heads) * self.head_dim

    def linear_shapes(self) -> dict:
        E, I, D = self.hidden, self.inter, self.head_dim
        return dict(qkv=(E, self.qkv_out), o=(self.heads * D, E),
                    gate_up=(E, 2 * I), down=(I, E))


class WeightMaker:
    def __init__(self, seed: int, cfg: dict, device) -> None:
        self.seed = int(seed)
        self.sizes = Sizes(cfg)
        self.std = {k: float(v) for k, v in cfg["assumed"]["weight_std"].items()}
        self.device = torch.device(device)

    def _gen(self, *tags) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, *tags))

    def normal(self, shape, std, *tags) -> torch.Tensor:
        """N(0, std^2) rounded to bf16."""
        x = torch.randn(shape, generator=self._gen(*tags), device=self.device)
        return x.mul_(std).to(torch.bfloat16)

    def norm(self, *tags) -> torch.Tensor:
        """An RMSNorm weight: U(0.5, 1.5) in f32."""
        x = torch.rand((self.sizes.hidden,), generator=self._gen(*tags), device=self.device)
        return x.add_(0.5)

    def embed(self) -> torch.Tensor:
        return self.normal((self.sizes.vocab, self.sizes.hidden), self.std["embed"], "embed")

    def lm_head(self) -> torch.Tensor:
        return self.normal((self.sizes.hidden, self.sizes.vocab), self.std["lm_head"], "lm_head")

    def final_ln(self) -> torch.Tensor:
        return self.norm("final_ln")

    def linear(self, li: int, name: str, expert=None) -> torch.Tensor:
        return self.normal(self.sizes.linear_shapes()[name], self.std["layer"], li, name, expert)

    def router(self, li: int) -> torch.Tensor:
        return self.normal((self.sizes.hidden, self.sizes.experts), self.std["router"], li, "router")

    def float_params(self) -> dict:
        """The float weights in the layout `quantize_params` reads."""
        return dict(embed=self.embed(), layers=_Layers(self), final_ln=self.final_ln(),
                    lm_head=self.lm_head())


class _Layers(Sequence):
    def __init__(self, maker: WeightMaker) -> None:
        self.maker = maker

    def __len__(self) -> int:
        return self.maker.sizes.layers

    def __getitem__(self, li):
        if not 0 <= li < len(self):
            raise IndexError(li)
        return _Layer(self.maker, li)


class _Layer(Mapping):
    def __init__(self, maker: WeightMaker, li: int) -> None:
        self.maker, self.li = maker, li
        if maker.sizes.experts:
            self._keys = ("input_ln", "qkv", "o", "post_ln", "router",
                          "experts_gate_up", "experts_down")
        else:
            self._keys = ("input_ln", "qkv", "o", "post_ln", "gate_up", "down")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, name):
        m, li = self.maker, self.li
        if name not in self._keys:
            raise KeyError(name)
        if name in ("input_ln", "post_ln"):
            return m.norm(li, name)
        if name == "router":
            return m.router(li)
        if name.startswith("experts_"):
            return _Experts(m, li, name[len("experts_"):])
        return m.linear(li, name)


class _Experts(Sequence):
    def __init__(self, maker: WeightMaker, li: int, name: str) -> None:
        self.maker, self.li, self.name = maker, li, name

    def __len__(self) -> int:
        return self.maker.sizes.experts

    def __getitem__(self, e):
        if not 0 <= e < len(self):
            raise IndexError(e)
        return self.maker.linear(self.li, self.name, e)
