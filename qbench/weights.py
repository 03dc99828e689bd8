"""Float weights made from the run's seed, on the device, tensor by tensor.

Each tensor has a generator of its own, seeded from the run's seed and the
tensor's tags (a model family's choice, such as layer, name and expert), so
any tensor can be made again alone: the program quantizes them at set-up,
and the reference makes the same ones again after the window. A family's
`float_params` lays them out as its `quantize_params` reads them, with the
layers as lazy sequences (`LazySeq`, `LazyMap`): a tensor is made when it
is read, so a model of about 93 GB in bf16 never exists whole.

Each is N(0, std^2) drawn in f32 and rounded once to bf16, the type a
checkpoint holds it in; RMSNorm weights are U(0.5, 1.5) in f32, so a path
that ignored them would show. The stds are the configuration file's
`assumed.weight_std`; each file gives the reason for its own.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping, Sequence
from typing import Callable, Tuple

import torch


def derive_seed(seed: int, *tags) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(str(int(seed) & ((1 << 64) - 1)).encode())
    for t in tags:
        h.update(b"\0" + str(t).encode())
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Sizes:
    """The widths every family shares, by the names the harness uses, and
    the serving precision; a family's Sizes adds its own (FFN, RoPE,
    attention window, experts)."""

    def __init__(self, cfg: dict) -> None:
        self.vocab = cfg["vocab_size"]
        self.hidden = cfg["hidden_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg.get("num_key_value_heads", self.heads)
        self.head_dim = cfg.get("head_dim") or self.hidden // self.heads
        self.eps = float(cfg.get("rms_norm_eps", 1e-6))
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


class WeightMaker:
    """Seeded draws on one device. `sizes` are the family's (the harness
    passes `family.sizes(cfg)`); the family's `float_params` reads them."""

    def __init__(self, seed: int, cfg: dict, device, sizes) -> None:
        self.seed = int(seed)
        self.sizes = sizes
        self.std = {k: float(v) for k, v in cfg["assumed"]["weight_std"].items()}
        self.device = torch.device(device)

    def _gen(self, *tags) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, *tags))

    def normal(self, shape, std, *tags) -> torch.Tensor:
        """N(0, std^2) rounded to bf16."""
        x = torch.randn(shape, generator=self._gen(*tags), device=self.device)
        return x.mul_(std).to(torch.bfloat16)

    def norm(self, width: int, *tags) -> torch.Tensor:
        """An RMSNorm weight: U(0.5, 1.5) in f32."""
        x = torch.rand((width,), generator=self._gen(*tags), device=self.device)
        return x.add_(0.5)


class LazySeq(Sequence):
    """n items, item i made by make(i) each time it is read."""

    def __init__(self, n: int, make: Callable) -> None:
        self._n, self._make = n, make

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._make(i)


class LazyMap(Mapping):
    """A mapping of `keys`, the value of a key made by make(key) each time
    it is read."""

    def __init__(self, keys: Tuple[str, ...], make: Callable) -> None:
        self._keys, self._make = keys, make

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, name):
        if name not in self._keys:
            raise KeyError(name)
        return self._make(name)
