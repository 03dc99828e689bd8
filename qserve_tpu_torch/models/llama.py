"""Llama-family model over quantized linear layers (W4A8 per-channel or
per-group, W8A8, or W16A16) and a paged KV4/KV8 cache, dense or with a
Mixtral-style sparse-MoE MLP (qserve_tpu/models/llama.py; the MoE weights
are built in models/mixtral.py).

  * packed varlen prefill (segment-id masked causal attention) writes the
    quantized KV pages and computes logits on each prompt's last token only;
  * single-token decode attends the paged history plus the current token's
    exact K/V, then appends every layer's new K/V in one batched write;
  * a prompt chunk attends the sequence's cached prefix pages plus itself
    (chunked prefill, prefix compute-skip), alone or fused with a decode
    batch into one packed [T+B] stream;
  * stacked [L, ...] weights stay stacked: a Python loop over layers takes
    views (`qweight[li]`), which copy nothing;
  * with INT8 activations the RMSNorm->INT8, SwiGLU->INT8 and
    attention-out->INT8 handoffs keep the int8 activation contract, and each
    layer's residual add rides inside the next norm (`add_rmsnorm_quant`);
    W16A16 adds eagerly and runs plain norms and bf16 products;
  * an MoE layer (MoELayerParams) adds its attention output eagerly, routes
    each token to its top-k experts and runs them either as a masked loop
    over every expert (short streams: decode) or as grouped GEMMs over a
    token stream sorted by expert (streams of moe_route_min_tokens or more).

bf16 rounding happens where the JAX package does it: the residual h, the
qkv/o/down GEMM outputs and the K/V handed to the cache are bf16; logits are
f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from qserve_tpu_torch.config import QuantSpec
from qserve_tpu_torch.kernels import attention, kv_cache as kvc, ops
from qserve_tpu_torch.layers import linear as lin
from qserve_tpu_torch.layers import rope
from qserve_tpu_torch.parallel import tp as tpmod
from qserve_tpu_torch.utils.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaArgs:
    """Static model hyperparameters."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    sliding_window: Optional[int] = None
    quant: QuantSpec = QuantSpec(4, 8, 4, True, -1)
    logit_dtype: Any = torch.float32
    # sparse MoE (Mixtral): 0 = dense MLP
    num_experts: int = 0
    moe_top_k: int = 2
    # streams at least this long take the routed (grouped-GEMM) dispatch,
    # whose work scales with top_k; shorter ones (decode) the masked loop
    # over every expert, whose cost is the experts' weight bytes either way
    moe_route_min_tokens: int = 1024
    # rows of one block of the routed stream (each block runs one expert)
    moe_route_block: int = 256
    # tensor parallelism: with tp_size > 1 this rank's weights hold 1/tp of
    # the heads, MLP channels and vocab columns (parallel/tp.py), and the
    # layer reduces o and down over the TP group
    tp_size: int = 1

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_out(self) -> int:
        return self.q_size + 2 * self.kv_size

    # ---- this rank's (TP-local) sizes; the global ones at tp = 1 ----
    @property
    def heads_local(self) -> int:
        assert self.num_heads % self.tp_size == 0
        return self.num_heads // self.tp_size

    @property
    def kv_heads_local(self) -> int:
        assert self.num_kv_heads % self.tp_size == 0
        return self.num_kv_heads // self.tp_size

    @property
    def q_size_local(self) -> int:
        return self.heads_local * self.head_dim

    @property
    def kv_size_local(self) -> int:
        return self.kv_heads_local * self.head_dim

    @property
    def intermediate_local(self) -> int:
        assert self.intermediate_size % self.tp_size == 0
        return self.intermediate_size // self.tp_size

    @property
    def vocab_local(self) -> int:
        assert self.vocab_size % self.tp_size == 0, (self.vocab_size, self.tp_size)
        return self.vocab_size // self.tp_size

    def linear_shapes(self) -> dict:
        """{name: (full [K, N], this rank's [K, N])} of a layer's linears."""
        E, I = self.hidden_size, self.intermediate_size
        il, ql = self.intermediate_local, self.q_size_local
        return dict(
            qkv=((E, self.qkv_out), (E, ql + 2 * self.kv_size_local)),
            o=((self.q_size, E), (ql, E)),
            gate_up=((E, 2 * I), (E, 2 * il)),
            down=((I, E), (il, E)),
        )

    @staticmethod
    def from_config_dict(cfg: dict, quant: QuantSpec) -> "LlamaArgs":
        """From a dense model's Hugging Face config.json dict
        (models/loader.py's args_from_config_dict). An MoE config goes
        through models/mixtral.py's args_from_config_dict instead."""
        if cfg.get("num_local_experts"):
            raise ValueError(
                "an MoE config (num_local_experts): use "
                "mixtral.args_from_config_dict"
            )
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
        return LlamaArgs(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=head_dim,
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-6),
            sliding_window=cfg.get("sliding_window"),
            quant=quant,
        )


class LlamaLayerParams(NamedTuple):
    """Stacked over layers: every field has a leading [L] dim."""

    input_ln: torch.Tensor  # f32 [L, E]
    qkv: lin.LinearParams  # [L, E, (Hq+2Hkv)*D]
    o: lin.LinearParams  # [L, Hq*D, E]
    post_ln: torch.Tensor  # f32 [L, E]
    gate_up: lin.LinearParams  # [L, E, 2*I]
    down: lin.LinearParams  # [L, I, E]


class MoELayerParams(NamedTuple):
    """Mixtral-style sparse-MoE layers, stacked over layers; the experts'
    linears carry a second leading [NE] dim."""

    input_ln: torch.Tensor  # f32 [L, E]
    qkv: lin.LinearParams  # [L, E, (Hq+2Hkv)*D]
    o: lin.LinearParams  # [L, Hq*D, E]
    post_ln: torch.Tensor  # f32 [L, E]
    router: torch.Tensor  # f32 [L, E, NE]
    gate_up: lin.LinearParams  # [L, NE, E, 2*I]
    down: lin.LinearParams  # [L, NE, I, E]


class LlamaParams(NamedTuple):
    embed: torch.Tensor  # bf16 [V, E]
    layers: Any  # LlamaLayerParams, or MoELayerParams (num_experts > 0)
    final_ln: torch.Tensor  # f32 [E]
    lm_head: Any  # bf16 [E, V], or lin.W8Linear (quant.lm_head_bits == 8)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def make_lm_head(w: torch.Tensor, qspec: QuantSpec) -> Any:
    """bf16 lm_head, or W8 per-channel when qspec.lm_head_bits == 8 (half
    the weight bytes of the logits product)."""
    if getattr(qspec, "lm_head_bits", 16) == 8:
        return lin.quantize_linear_from_float(w.to(torch.float32), 8)
    return w.to(torch.bfloat16)


def lm_head_matmul(h: torch.Tensor, lmh, out_dtype) -> torch.Tensor:
    """Logits product against either lm_head form."""
    if isinstance(lmh, lin.W8Linear):
        q, s, _ = ops.quant_per_token(h, False)
        return lin.apply_linear(lmh, lin.QuantAct(q, s, None), out_dtype=out_dtype)
    return ops.matmul(h, lmh, out_dtype)


def _check_dense(args: LlamaArgs) -> None:
    assert args.num_experts == 0, (
        "MoE args need the Mixtral builder (this one makes DENSE layers)"
    )


def empty_linear(lead: tuple, K, N, device, quant: QuantSpec) -> lin.LinearParams:
    """Uninitialised stacked [*lead, ...] weights of quant's flavor ([L] for
    a dense layer's linears, [L, NE] for MoE experts)."""

    def empty(shape, dtype):
        return torch.empty((*lead, *shape), dtype=dtype, device=device)

    wb, gs = quant.weight_bits, quant.group_size
    if wb == 16:
        return lin.W16Linear(empty((K, N), torch.bfloat16))
    if wb == 8:
        return lin.W8Linear(empty((K, N), torch.int8), empty((N,), torch.float32))
    if wb != 4:
        raise ValueError(f"weight_bits={wb}")
    if gs == -1:
        return lin.W4ChnLinear(
            empty((K // 2, N), torch.int8), empty((N,), torch.float32),
            empty((N,), torch.float32),
        )
    return lin.W4GrpLinear(
        empty((K // 2, N), torch.int8), empty((K // gs, N), torch.int8),
        empty((K // gs, N), torch.int8), empty((N,), torch.float32),
    )


def _stacked_layers(args: LlamaArgs, device, weight_of, rank: int = 0) -> LlamaLayerParams:
    """Quantize layer by layer into preallocated stacked tensors, so the
    float model never exists whole. weight_of(li, name, shape) -> the full
    float [K, N]; each is cut to rank `rank`'s shard (parallel/tp.py) and
    quantized on its own."""
    E, L = args.hidden_size, args.num_layers
    shapes = args.linear_shapes()
    lins = {n: empty_linear((L,), *local, device, args.quant)
            for n, (_, local) in shapes.items()}
    for li in range(L):
        for name, (full, _) in shapes.items():
            w = tpmod.shard_weight(weight_of(li, name, full), name, args, rank)
            quantize_into(lins[name], li, w, args.quant)
    return LlamaLayerParams(
        input_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        post_ln=torch.ones((L, E), dtype=torch.float32, device=device),
        **lins,
    )


def quantize_into(dst: lin.LinearParams, index, w: torch.Tensor,
                  quant: QuantSpec) -> None:
    """Quantize the float weight w [K, N] into dst[index] of stacked weights."""
    p = lin.quantize_linear_from_float(w, quant.weight_bits, quant.group_size)
    for d, src in zip(dst, p):
        d[index].copy_(src)


def random_quantized_params(
    seed: int, args: LlamaArgs, device="cuda", scale: float = 0.02, rank: int = 0
) -> LlamaParams:
    """Random weights from a seeded torch.Generator, quantized layer by layer
    on the device. At tp_size > 1, rank `rank`'s shard of the same weights
    (parallel/tp.py random_quantized_params_tp)."""
    _check_dense(args)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def weight_of(li, name, shape):
        return torch.randn(shape, generator=gen, device=device) * scale

    layers = _stacked_layers(args, device, weight_of, rank)
    E, V = args.hidden_size, args.vocab_size
    embed = torch.randn(
        (V, E), generator=gen, device=device, dtype=torch.bfloat16
    ) * scale
    lm_head = make_lm_head(
        tpmod.shard_vocab(
            torch.randn((E, V), generator=gen, device=device, dtype=torch.bfloat16)
            * scale, args, rank),
        args.quant,
    )
    return LlamaParams(
        embed=embed, layers=layers,
        final_ln=torch.ones((E,), dtype=torch.float32, device=device),
        lm_head=lm_head,
    )


def random_float_params(seed: int, args: LlamaArgs, device="cpu",
                        scale: float = 0.02) -> dict:
    """Random float weights in the JAX package's random_float_params layout
    (per layer input_ln, qkv, o, post_ln, gate_up, down as f32 [K, N];
    embed [V, E], final_ln, lm_head [E, V], all f32), drawn in
    random_quantized_params's order from the same seeded generator: its
    quantize_params (any rank's quantize_params_tp) is
    random_quantized_params(seed, args) (that rank's share). The embedding
    and lm_head are drawn in bf16 there, so their f32 values here are bf16
    values. JAX's PRNG bits cannot be reproduced: tests carry the JAX
    package's own float weights across as numpy."""
    _check_dense(args)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    E, V = args.hidden_size, args.vocab_size

    def randn(shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device, dtype=dtype)
                * scale).to(torch.float32)

    def ones():
        return torch.ones((E,), dtype=torch.float32, device=device)

    full = {n: f for n, (f, _) in args.linear_shapes().items()}
    layers = [dict(input_ln=ones(), qkv=randn(full["qkv"]), o=randn(full["o"]),
                   post_ln=ones(), gate_up=randn(full["gate_up"]),
                   down=randn(full["down"]))
              for _ in range(args.num_layers)]
    embed = randn((V, E), torch.bfloat16)
    return dict(embed=embed, layers=layers, final_ln=ones(),
                lm_head=randn((E, V), torch.bfloat16))


def quantize_params(float_params: dict, args: LlamaArgs, device="cuda",
                    rank: int = 0) -> LlamaParams:
    """Quantize float weights (dict of [K, N] arrays per layer, the JAX
    package's random_float_params layout) into the serving format; at
    tp_size > 1, rank `rank`'s shards (parallel/tp.py quantize_params_tp)."""
    _check_dense(args)
    device = resolve_device(device)

    def t(x, dtype=torch.float32):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # a writable copy
        return x.to(device=device, dtype=dtype)

    fl = float_params["layers"]
    layers = _stacked_layers(args, device, lambda li, name, _: t(fl[li][name]), rank)
    layers = layers._replace(
        input_ln=torch.stack([t(x["input_ln"]) for x in fl]),
        post_ln=torch.stack([t(x["post_ln"]) for x in fl]),
    )
    return LlamaParams(
        embed=t(float_params["embed"], torch.bfloat16),
        layers=layers,
        final_ln=t(float_params["final_ln"]),
        lm_head=make_lm_head(
            tpmod.shard_vocab(t(float_params["lm_head"]), args, rank), args.quant),
    )


# ---------------------------------------------------------------------------
# Layer forward
# ---------------------------------------------------------------------------


def _layer_forward(
    layers,  # LlamaLayerParams or MoELayerParams, stacked over layers
    li: int,
    h: torch.Tensor,  # [T, E] bf16 residual stream EXCLUDING delta
    delta: torch.Tensor,  # [T, E] previous sub-block's un-added output
    cos: torch.Tensor,
    sin: torch.Tensor,
    args: LlamaArgs,
    attend,  # fn(q [T,Hq,D], k, v, li) -> [T,Hq,D]
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder layer. Returns (h, delta_out, (k, v)); the KV-cache
    append is the caller's, batched across layers. The MLP is the layers'
    type's: dense SwiGLU, or the sparse MoE block (_moe_mlp). At
    tp_size > 1 the rank's heads and channels are the local ones, and o and
    down (or the expert sum) are reduced over the TP group."""
    T = h.shape[0]
    eps = args.rms_eps
    int8_act = args.quant.act_bits == 8
    gs = args.quant.group_size if args.quant.group_size > 0 else 128
    qkv_p, o_p = layers.qkv.layer(li), layers.o.layer(li)
    gu_p, down_p = layers.gate_up.layer(li), layers.down.layer(li)

    if int8_act:
        h, q8, s8, a8 = ops.add_rmsnorm_quant(
            h, delta, layers.input_ln[li], eps, lin.needs_act_sum(qkv_p)
        )
        qkv = lin.apply_linear(qkv_p, lin.QuantAct(q8, s8, a8), gs)
    else:
        h = h + delta.to(h.dtype)
        qkv = lin.apply_linear(qkv_p, ops.rmsnorm(h, layers.input_ln[li], eps), gs)
    q, k, v = qkv.split(
        [args.q_size_local, args.kv_size_local, args.kv_size_local], dim=-1)
    q = rope.apply_rope(q.reshape(T, args.heads_local, args.head_dim), cos, sin)
    k = rope.apply_rope(k.reshape(T, args.kv_heads_local, args.head_dim), cos, sin)
    v = v.reshape(T, args.kv_heads_local, args.head_dim)

    attn = attend(q, k, v, li).reshape(T, args.q_size_local)
    if int8_act:
        o = lin.apply_linear(
            o_p, lin.QuantAct(*ops.quant_per_token(attn, lin.needs_act_sum(o_p))),
            gs,
        )
    else:
        o = lin.apply_linear(o_p, attn, gs)
    o = tpmod.tp_all_reduce(o, args)
    if isinstance(layers, MoELayerParams):
        # a plain add and a plain RMSNorm, as the JAX package's MoE branch
        h = h + o.to(h.dtype)
        x = ops.rmsnorm(h, layers.post_ln[li], eps)
        d = _moe_mlp(layers.router[li], gu_p, down_p, x, args, int8_act, gs)
    elif int8_act:
        h, g8, gsc, gsum = ops.add_rmsnorm_quant(
            h, o, layers.post_ln[li], eps, lin.needs_act_sum(gu_p)
        )
        gu = lin.apply_linear(gu_p, lin.QuantAct(g8, gsc, gsum), gs)
        y8, ysc, ysum = ops.silu_mul_quant(gu, lin.needs_act_sum(down_p))
        d = lin.apply_linear(down_p, lin.QuantAct(y8, ysc, ysum), gs)
    else:
        h = h + o.to(h.dtype)
        gu = lin.apply_linear(gu_p, ops.rmsnorm(h, layers.post_ln[li], eps), gs)
        d = lin.apply_linear(down_p, ops.silu_mul(gu), gs)
    d = tpmod.tp_all_reduce(d, args)
    return h, d.to(h.dtype), (k.to(torch.bfloat16), v.to(torch.bfloat16))


def _moe_mlp(
    router: torch.Tensor,  # f32 [E, NE], one layer's
    gu_p: lin.LinearParams,  # one layer's experts [NE, E, 2I]
    down_p: lin.LinearParams,  # [NE, I, E]
    x: torch.Tensor,  # [T, E] bf16, the post-attention RMSNorm's output
    args: LlamaArgs,
    int8_act: bool,
    gs: int,
) -> torch.Tensor:
    """Sparse-MoE MLP -> f32 [T, E]: softmax router, top-k with renormalized
    weights, SwiGLU experts. Streams of moe_route_min_tokens or more take
    the routed grouped GEMMs (_moe_routed_ffn); shorter ones run every
    expert over every token in expert order, a zero routing weight masking
    the tokens an expert does not serve (decode reads every expert's
    weights either way)."""
    T = x.shape[0]
    n_exp = args.num_experts
    router_logits = ops.matmul(x, router.to(torch.bfloat16), torch.float32)
    probs = torch.softmax(router_logits, dim=-1)  # [T, NE]
    # torch.topk's order among equal values is unspecified; random f32
    # probabilities do not tie
    topv, topi = torch.topk(probs, args.moe_top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)  # [T, k]

    if (T >= args.moe_route_min_tokens and lin.supports_routed(gu_p)
            and lin.supports_routed(down_p)):
        return _moe_routed_ffn(gu_p, down_p, x, topv, topi, args, int8_act, gs)

    combine = torch.zeros((T, n_exp), dtype=torch.float32, device=x.device)
    combine.scatter_(1, topi, topv)  # each token's k weights, 0 elsewhere
    if int8_act:
        qx = lin.QuantAct(*ops.quant_per_token(x, lin.needs_act_sum(gu_p)))
    acc = torch.zeros((T, args.hidden_size), dtype=torch.float32, device=x.device)
    for e in range(n_exp):
        ge, de = gu_p.layer(e), down_p.layer(e)  # views of expert e
        if int8_act:
            gu = lin.apply_linear(ge, qx, gs)
            y8, ysc, ysum = ops.silu_mul_quant(gu, lin.needs_act_sum(de))
            d = lin.apply_linear(de, lin.QuantAct(y8, ysc, ysum), gs)
        else:
            gu = lin.apply_linear(ge, x, gs)
            d = lin.apply_linear(de, ops.silu_mul(gu), gs)
        acc = acc + combine[:, e : e + 1] * d.to(torch.float32)
    return acc


def _moe_routed_ffn(
    gu_p: lin.LinearParams,
    down_p: lin.LinearParams,
    x: torch.Tensor,  # [T, E] bf16
    topv: torch.Tensor,  # f32 [T, k] renormalized routing weights
    topi: torch.Tensor,  # int64 [T, k] experts
    args: LlamaArgs,
    int8_act: bool,
    gs: int,
) -> torch.Tensor:
    """Routed (grouped-GEMM) expert dispatch -> f32 [T, E]. The T*k (token,
    expert) rows sort by expert into a padded stream of P rows in which
    every moe_route_block-row block belongs to one expert; the routed GEMMs
    multiply each block by its expert's weights, so the work scales with k
    rather than with the number of experts. Exact: nothing is dropped, pad
    rows are zero and come out zero. Everything stays on the device; P is
    the JAX package's static bound, so nothing reads the device."""
    T, E = x.shape
    dev = x.device
    st, dest, rows, block_expert, P = route_layout(
        topi, args.num_experts, args.moe_route_block
    )

    if int8_act:
        # quantize the T rows once, scatter the int8 rows and scales into the
        # stream (pad rows: q = 0, scale 0, sum 0 -> an exact 0 output)
        q, qs, qsum = ops.quant_per_token(x, lin.needs_act_sum(gu_p))
        qp = torch.zeros((P, E), dtype=torch.int8, device=dev)
        qp[dest] = q[st]
        qsp = torch.zeros((P, 1), dtype=torch.float32, device=dev)
        qsp[dest] = qs[st]
        qsump = None
        if qsum is not None:
            qsump = torch.zeros((P, 1), dtype=torch.float32, device=dev)
            qsump[dest] = qsum[st]
        gu = lin.apply_linear_routed(gu_p, lin.QuantAct(qp, qsp, qsump), block_expert, gs)
        y8, ysc, ysum = ops.silu_mul_quant(gu, lin.needs_act_sum(down_p))
        d = lin.apply_linear_routed(down_p, lin.QuantAct(y8, ysc, ysum), block_expert, gs)
    else:
        xp = torch.zeros((P, E), dtype=x.dtype, device=dev)
        xp[dest] = x[st]
        gu = lin.apply_linear_routed(gu_p, xp, block_expert, gs)
        d = lin.apply_linear_routed(down_p, ops.silu_mul(gu), block_expert, gs)

    # combine: each token's k rows in j order, summed in f32 from 0. The
    # JAX package scatter-adds them instead; for k = 2 both give a + b
    # exactly, and a gather needs no atomics at any k.
    acc = torch.zeros((T, E), dtype=torch.float32, device=dev)
    for j in range(rows.shape[1]):
        acc = acc + topv[:, j : j + 1] * d[rows[:, j]].to(torch.float32)
    return acc


def route_layout(topi: torch.Tensor, n_exp: int, bblk: int):
    """Layout of the routed stream of the tokens' experts topi [T, k]:
    the T*k (token, expert) rows sorted by expert (stably), each expert's
    rows padded to whole bblk-row blocks. Returns (st, dest, rows,
    block_expert, P): the token and the stream row of each sorted row, the
    stream row of each (token, j) [T, k], the expert of each block (int32
    [P / bblk]; all-pad tail blocks name the last expert) and the stream's
    length P, the JAX package's static bound. Nothing reads the device."""
    T, kk = topi.shape
    dev = topi.device
    flat_e = topi.reshape(-1)  # row t*kk + j = token t's j-th expert
    order = torch.argsort(flat_e, stable=True)  # jnp.argsort is stable
    se, st = flat_e[order], order // kk
    # experts' row counts without bincount, which reads the device on CUDA
    counts = (se[:, None] == torch.arange(n_exp, device=dev)).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * kk, device=dev) - starts[se]
    padded = (counts + bblk - 1) // bblk * bblk
    ends = torch.cumsum(padded, 0)
    dest = (ends - padded)[se] + rank
    rows = torch.empty_like(dest)
    rows[order] = dest

    P = (-(-T * kk // bblk) + n_exp) * bblk  # every expert wastes < bblk rows
    block_expert = torch.searchsorted(
        ends, torch.arange(P // bblk, device=dev) * bblk, right=True
    ).clamp(max=n_exp - 1).to(torch.int32)
    return st, dest, rows.view(T, kk), block_expert, P


def _run_layers(params: LlamaParams, h, cos, sin, args: LlamaArgs, attend):
    """All layers; returns (h, (k_all, v_all) bf16 [L, T, Hkv_local, D])."""
    T = h.shape[0]
    shape = (args.num_layers, T, args.kv_heads_local, args.head_dim)
    k_all = torch.empty(shape, dtype=torch.bfloat16, device=h.device)
    v_all = torch.empty(shape, dtype=torch.bfloat16, device=h.device)
    delta = torch.zeros_like(h)
    for li in range(args.num_layers):
        h, delta, (k, v) = _layer_forward(
            params.layers, li, h, delta, cos, sin, args, attend
        )
        k_all[li] = k
        v_all[li] = v
    return h + delta, (k_all, v_all)


def _lm_head(h: torch.Tensor, params: LlamaParams, args: LlamaArgs) -> torch.Tensor:
    """Logits [B, V]: the rank's vocab columns, gathered across TP."""
    return tpmod.tp_all_gather_cols(
        lm_head_matmul(h, params.lm_head, args.logit_dtype), args)


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def prefill(
    params: LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [T] int32, packed prompts (0-padded tail)
    positions: torch.Tensor,  # [T] int32 position within each prompt
    segment_ids: torch.Tensor,  # [T] int32, 0 = padding
    page_ids: torch.Tensor,  # [T] int32 destination page (-1 = drop)
    slots: torch.Tensor,  # [T] int32 slot within page
    last_token_idx: torch.Tensor,  # [B] int32 index of each prompt's last token
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Packed varlen prefill. Returns (logits [B, V], kv updated in place)."""
    h = params.embed[token_ids.long()].to(torch.bfloat16)
    return prefill_from_hidden(
        params, kv, h, positions, segment_ids, page_ids, slots,
        last_token_idx, args,
    )


def prefill_from_hidden(
    params: LlamaParams,
    kv: kvc.KVCache,
    h: torch.Tensor,  # [T, E] input embeddings
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    page_ids: torch.Tensor,
    slots: torch.Tensor,
    last_token_idx: torch.Tensor,
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)

    def attend(q, k, v, _li):
        return attention.prefill_attention(
            q, k, v, segment_ids, sliding_window=args.sliding_window
        )

    h, (k_all, v_all) = _run_layers(params, h, cos, sin, args, attend)
    kv = kvc.append_all_layers(
        kv, k_all, v_all, page_ids, slots,
        args.quant.kv_bits, args.quant.kv_zero_point,
    )
    h_last = ops.rmsnorm(h[last_token_idx.long()], params.final_ln, args.rms_eps)
    return _lm_head(h_last, params, args), kv


def _decode_slots(block_tables, context_lens, page_size):
    """(positions, page_ids, slots) of each decode row's current token;
    rows with ctx == 0 are padding and drop their write (page -1)."""
    positions = context_lens - 1
    active = context_lens > 0
    logical_page = torch.where(active, positions // page_size, 0)
    page_ids = torch.where(
        active,
        torch.gather(block_tables, 1, logical_page[:, None].long())[:, 0],
        -1,
    ).to(torch.int32)
    slots = torch.where(active, positions % page_size, 0).to(torch.int32)
    return positions, page_ids, slots


def prefill_chunk(
    params: LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [T] int32, ONE prompt's chunk (0-padded tail)
    positions: torch.Tensor,  # [T] int32 absolute positions (>= start)
    segment_ids: torch.Tensor,  # [T] int32, 0 = padding
    page_ids: torch.Tensor,  # [T] int32 destination page (-1 = drop)
    slots: torch.Tensor,  # [T] int32
    last_token_idx: torch.Tensor,  # [1] int32
    block_tables: torch.Tensor,  # [1, maxP] int32, for the cached prefix
    prefix_len: int,  # host int: positions [0, prefix_len) are cached
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Prefill one chunk of a prompt whose prefix KV is already cached
    (chunked prefill / prefix compute-skip). Returns (logits [1, V], kv
    updated in place)."""
    h = params.embed[token_ids.long()].to(torch.bfloat16)
    return prefill_chunk_from_hidden(
        params, kv, h, positions, segment_ids, page_ids, slots,
        last_token_idx, block_tables, prefix_len, args,
    )


def prefill_chunk_from_hidden(
    params: LlamaParams,
    kv: kvc.KVCache,
    h: torch.Tensor,  # [T, E] input embeddings
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    page_ids: torch.Tensor,
    slots: torch.Tensor,
    last_token_idx: torch.Tensor,
    block_tables: torch.Tensor,
    prefix_len: int,
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)

    def attend(q, k, v, li):
        return attention.prefix_prefill_attention(
            q, k, v, segment_ids, positions, kv, block_tables, prefix_len,
            li, args.quant.kv_bits, sliding_window=args.sliding_window,
        )

    h, (k_all, v_all) = _run_layers(params, h, cos, sin, args, attend)
    kv = kvc.append_all_layers(
        kv, k_all, v_all, page_ids, slots,
        args.quant.kv_bits, args.quant.kv_zero_point,
    )
    h_last = ops.rmsnorm(h[last_token_idx.long()], params.final_ln, args.rms_eps)
    return _lm_head(h_last, params, args), kv


def prefill_chunk_with_decode(
    params: LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [T] int32, ONE prompt's chunk (0-padded tail)
    positions: torch.Tensor,  # [T] int32 absolute positions (>= start)
    segment_ids: torch.Tensor,  # [T] int32, 0 = padding
    page_ids: torch.Tensor,  # [T] int32 destination page (-1 = drop)
    slots: torch.Tensor,  # [T] int32
    last_token_idx: torch.Tensor,  # [1] int32
    chunk_tables: torch.Tensor,  # [1, maxP] int32, the chunk's cached prefix
    prefix_len: int,  # host int
    d_token_ids: torch.Tensor,  # [B] int32 decode batch current tokens
    d_block_tables: torch.Tensor,  # [B, maxP] int32
    d_context_lens: torch.Tensor,  # [B] int32 incl. current token; 0 = pad row
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One prefill chunk AND a decode batch in a single step: the chunk's
    [T] tokens and the decode batch's [B] tokens run as one packed [T+B]
    stream through every GEMM and elementwise kernel, so the decode rows
    share the chunk's pass over the weights and running sequences keep
    generating while a long prompt admits. Attention splits by row span:
    rows [:T] take the prefix-prefill op, rows [T:] the paged decode op.
    Returns (logits [1+B, V], kv updated in place): row 0 = the chunk's
    last token (meaningful on the final chunk only), rows 1: = decode rows.
    """
    T = token_ids.shape[0]
    d_positions, d_page_ids, d_slots = _decode_slots(
        d_block_tables, d_context_lens, kv.page_size
    )
    h = params.embed[torch.cat([token_ids, d_token_ids]).long()].to(torch.bfloat16)
    cos, sin = rope.rope_cos_sin(
        torch.cat([positions, d_positions]), args.head_dim, args.rope_theta
    )

    def attend(q, k, v, li):
        oc = attention.prefix_prefill_attention(
            q[:T], k[:T], v[:T], segment_ids, positions, kv, chunk_tables,
            prefix_len, li, args.quant.kv_bits,
            sliding_window=args.sliding_window,
        )
        od = attention.paged_decode_attention(
            q[T:], kv, d_block_tables, d_context_lens, li, k[T:], v[T:],
            args.quant.kv_bits, sliding_window=args.sliding_window,
        )
        return torch.cat([oc, od], dim=0)

    h, (k_all, v_all) = _run_layers(params, h, cos, sin, args, attend)
    kv = kvc.append_all_layers(
        kv, k_all[:, :T], v_all[:, :T], page_ids, slots,
        args.quant.kv_bits, args.quant.kv_zero_point,
    )
    kv = kvc.append_all_layers(
        kv, k_all[:, T:], v_all[:, T:], d_page_ids, d_slots,
        args.quant.kv_bits, args.quant.kv_zero_point,
    )
    h_sel = torch.cat([h[last_token_idx.long()], h[T:]], dim=0)  # [1+B, E]
    h_sel = ops.rmsnorm(h_sel, params.final_ln, args.rms_eps)
    return _lm_head(h_sel, params, args), kv


def decode(
    params: LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [B] int32 current tokens
    block_tables: torch.Tensor,  # [B, maxP] int32
    context_lens: torch.Tensor,  # [B] int32 INCLUDING the current token; 0 = pad
    args: LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One decode step. Attention reads the cache (positions < ctx-1) and
    the current token's fresh K/V; the appends for all layers follow in one
    batched write. Returns (logits [B, V], kv updated in place)."""
    positions, page_ids, slots = _decode_slots(
        block_tables, context_lens, kv.page_size
    )

    h = params.embed[token_ids.long()].to(torch.bfloat16)
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)

    def attend(q, k, v, li):
        return attention.paged_decode_attention(
            q, kv, block_tables, context_lens, li, k, v, args.quant.kv_bits,
            sliding_window=args.sliding_window,
        )

    h, (k_all, v_all) = _run_layers(params, h, cos, sin, args, attend)
    kv = kvc.append_all_layers(
        kv, k_all, v_all, page_ids, slots,
        args.quant.kv_bits, args.quant.kv_zero_point,
    )
    h = ops.rmsnorm(h, params.final_ln, args.rms_eps)
    return _lm_head(h, params, args), kv


# ---------------------------------------------------------------------------
# Teacher-forced scoring (perplexity evaluation)
# ---------------------------------------------------------------------------


def teacher_forced_nll(
    params: LlamaParams,
    token_ids: torch.Tensor,  # [T] int32, one sequence (0-padded tail)
    length: int,  # number of valid tokens
    args: LlamaArgs,
    row_chunk: int = 256,
    simulate_kv_quant: bool = False,
) -> Tuple[torch.Tensor, int]:
    """Sum of -log p(token[t+1] | tokens[:t+1]) for t+1 < length.

    Runs the serving forward (the prefill's kernels) without touching a KV
    cache, then folds the lm_head and the cross-entropy over row_chunk rows,
    so the [T, V] f32 logits never exist at once. Returns (nll_sum, count):
    an f32 0-d tensor on the params' device and a host int, so a window
    costs one read-back.

    simulate_kv_quant=True also round-trips every K/V through the serving
    KV quantizer (per token and head, args.quant.kv_bits) before attention,
    so the measured loss covers the KV4/KV8 cache too."""
    T = token_ids.shape[0]
    assert T % row_chunk == 0, f"T={T} not a multiple of row_chunk={row_chunk}"
    length = int(length)
    dev = token_ids.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    segment_ids = (positions < length).to(torch.int32)

    h = params.embed[token_ids.long()].to(torch.bfloat16)
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)

    def kv_roundtrip(x):
        from qserve_tpu_torch.quant import qoq

        q, scale, zero = qoq.quantize_kv(
            x.to(torch.float32), bits=args.quant.kv_bits,
            asymmetric=args.quant.kv_zero_point,
        )
        return qoq.dequantize_kv(q, scale, zero).to(x.dtype)

    def attend(q, k, v, _li):
        if simulate_kv_quant:
            k, v = kv_roundtrip(k), kv_roundtrip(v)
        return attention.prefill_attention(
            q, k, v, segment_ids, sliding_window=args.sliding_window
        )

    h, _ = _run_layers(params, h, cos, sin, args, attend)
    h = ops.rmsnorm(h, params.final_ln, args.rms_eps)

    targets = torch.roll(token_ids, -1).long()  # target[t] = token[t+1]
    pred_mask = (positions + 1 < length).to(torch.float32)
    nll = torch.zeros((), dtype=torch.float32, device=dev)
    for r0 in range(0, T, row_chunk):
        rows = slice(r0, r0 + row_chunk)
        logits = tpmod.tp_all_gather_cols(
            lm_head_matmul(h[rows], params.lm_head, torch.float32), args)
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(1, targets[rows, None])[:, 0]
        nll = nll + ((lse - tl) * pred_mask[rows]).sum()
    return nll, max(length - 1, 0)


# ---------------------------------------------------------------------------
# Float reference forward (an oracle; no cache, full logits)
# ---------------------------------------------------------------------------


def reference_forward_float(
    float_params: dict, args: LlamaArgs, token_ids: torch.Tensor
) -> torch.Tensor:
    """Plain f32 forward of the same architecture on one sequence [T] ->
    logits f32 [T, V], on the device of token_ids.

    An oracle, not a serving path: every product is f32, and attention is
    attention.prefill_attention_plain, called by name on every device,
    because the prefill kernel (K3) takes bf16 operands only. Nothing is
    cast to bf16."""
    T = token_ids.shape[0]
    dev = token_ids.device

    def f32(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        return x.to(device=dev, dtype=torch.float32)

    h = f32(float_params["embed"])[token_ids.long()]
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    cos, sin = rope.rope_cos_sin(positions, args.head_dim, args.rope_theta)
    seg = torch.ones((T,), dtype=torch.int32, device=dev)

    def rms(x, w):
        v = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(v + args.rms_eps) * f32(w)

    def swiglu(x, gate_up, down):
        g, u = (x @ f32(gate_up)).chunk(2, dim=-1)
        return (torch.nn.functional.silu(g) * u) @ f32(down)

    def moe_mlp(x, fl):
        probs = torch.softmax(x @ f32(fl["router"]), dim=-1)
        topv, topi = torch.topk(probs, args.moe_top_k, dim=-1)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(args.num_experts):
            d = swiglu(x, fl["experts_gate_up"][e], fl["experts_down"][e])
            w = torch.where(topi == e, topv, torch.zeros_like(topv)).sum(dim=-1)
            out = out + w[:, None] * d
        return out

    for fl in float_params["layers"]:
        x = rms(h, fl["input_ln"])
        q, k, v = (x @ f32(fl["qkv"])).split(
            [args.q_size, args.kv_size, args.kv_size], dim=-1)
        q = rope.apply_rope(q.reshape(T, args.num_heads, args.head_dim), cos, sin)
        k = rope.apply_rope(k.reshape(T, args.num_kv_heads, args.head_dim), cos, sin)
        v = v.reshape(T, args.num_kv_heads, args.head_dim)
        attn = attention.prefill_attention_plain(q, k, v, seg)
        h = h + attn.reshape(T, -1) @ f32(fl["o"])
        x = rms(h, fl["post_ln"])
        if args.num_experts > 0:
            h = h + moe_mlp(x, fl)
        else:
            h = h + swiglu(x, fl["gate_up"], fl["down"])
    h = rms(h, float_params["final_ln"])
    return h @ f32(float_params["lm_head"])
