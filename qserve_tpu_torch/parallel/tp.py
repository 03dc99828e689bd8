"""Tensor parallelism: per-shard quantization and the step's collectives
(qserve_tpu/parallel/tp.py).

Each rank is one process (parallel/distributed.py) that holds one shard:

  * qkv and gate_up are column-parallel: rank r holds its own q, k and v
    head blocks (concatenated q_r ++ k_r ++ v_r) and its own gate and up
    channel blocks (g_r ++ u_r), so the SwiGLU's halves stay paired;
  * o and down are row-parallel: rank r holds their row block r, and the
    layer sums the ranks' partial outputs (`tp_all_reduce`) where the JAX
    package `psum`s (after o, and after down or the MoE expert sum);
  * the lm_head is vocab-column-parallel: rank r holds columns
    [r V/tp, (r+1) V/tp), and the logits are gathered in rank order
    (`tp_all_gather_cols`);
  * the KV cache holds the rank's kv heads (worker/cache_engine.py);
  * embeddings, norms and the MoE router are replicated.

Quantization is PER SHARD, as in the JAX package: each rank quantizes its
own [K_local, N_local] block, so a row-parallel shard's scales are finer
than one whole-row scale, and nibble packing runs on the shard-local
matrix. `quantize_params_tp` and `random_quantized_params_tp` return one
rank's LlamaParams; rank r's arrays equal the JAX package's global
`quantize_params_tp` arrays sliced by their PartitionSpecs
(convert/from_jax.py `tp_shard_from_jax`).

The collectives are no-ops at tp = 1, so the single-rank path does not
change by a bit. LlamaArgs holds static sizes only (`tp_size`); the process
group lives here, set once per process by `init_distributed`. Each sum is
reduced in its own dtype: o and the dense down in bf16 (gloo and nccl take
it; for two ranks one bf16 add is the f32 sum rounded once, what the JAX
`psum` gives, which tests/test_torch_tp_engine.py checks over gloo), the
MoE expert sum in f32.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

_GROUP = None
_BACKEND: Optional[str] = None


class CollectiveStats:
    """Calls of each collective, and with `timed` their host ms: the device
    is synchronised before and after each call, so the time is the
    transport's alone, not the wait for the kernels queued before it (gloo
    synchronises at every collective anyway)."""

    def __init__(self) -> None:
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.ms = {"all_reduce": 0.0, "all_gather": 0.0}


STATS = CollectiveStats()


def set_tp_group(group, backend: Optional[str]) -> None:
    global _GROUP, _BACKEND
    _GROUP, _BACKEND = group, backend


def get_tp_group():
    return _GROUP


def tp_rank() -> int:
    """This process's rank in its TP group (0 when not distributed)."""
    import torch.distributed as dist

    return dist.get_rank(_GROUP) if _GROUP is not None else 0


def tp_world() -> int:
    import torch.distributed as dist

    return dist.get_world_size(_GROUP) if _GROUP is not None else 1


def _group():
    if _GROUP is None:
        raise RuntimeError(
            "tp_size > 1 needs a TP group: call parallel.distributed.init_distributed "
            "in each rank first")
    return _GROUP


def _run(kind: str, x: torch.Tensor, fn):
    STATS.calls[kind] += 1
    if not STATS.timed:
        return fn()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t = time.perf_counter()
    out = fn()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    STATS.ms[kind] += (time.perf_counter() - t) * 1e3
    return out


def tp_all_reduce(x: torch.Tensor, args) -> torch.Tensor:
    """Sum of the ranks' partial outputs x [T, N] (the JAX package's `psum`
    over the tp axis); x itself at tp = 1."""
    if args.tp_size == 1:
        return x
    import torch.distributed as dist

    group = _group()

    def reduce():
        y = x.contiguous()
        dist.all_reduce(y, group=group)
        return y

    return _run("all_reduce", x, reduce)


def tp_all_gather_cols(x: torch.Tensor, args) -> torch.Tensor:
    """The ranks' column blocks x [B, N / tp] side by side in rank order ->
    [B, N] (the JAX package's tiled `all_gather` on axis 1); x at tp = 1."""
    if args.tp_size == 1:
        return x
    import torch.distributed as dist

    group = _group()

    def gather():
        y = x.contiguous()
        parts = [torch.empty_like(y) for _ in range(args.tp_size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=-1)

    return _run("all_gather", x, gather)


def group_min(n: int, device) -> int:
    """The least of the TP group's values of n (one all_reduce)."""
    import torch.distributed as dist

    if _GROUP is None:
        return n
    dev = device if _BACKEND == "nccl" else "cpu"
    t = torch.tensor([n], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_GROUP)
    return int(t.item())


# ---------------------------------------------------------------------------
# shards of the full float weights
# ---------------------------------------------------------------------------


def shard_weight(w: torch.Tensor, name: str, args, rank: int) -> torch.Tensor:
    """Rank `rank`'s block of one full float weight [K, N] of a layer:
    qkv -> q_r ++ k_r ++ v_r (head blocks), gate_up -> g_r ++ u_r (channel
    blocks), o and down -> their row block r. w itself at tp = 1."""
    tp = args.tp_size
    if tp == 1:
        return w
    assert 0 <= rank < tp, (rank, tp)
    if name == "qkv":
        qs, ks = args.q_size, args.kv_size
        ql, kl = args.q_size_local, args.kv_size_local
        return torch.cat([w[:, rank * ql:(rank + 1) * ql],
                          w[:, qs + rank * kl:qs + (rank + 1) * kl],
                          w[:, qs + ks + rank * kl:qs + ks + (rank + 1) * kl]], dim=1)
    if name == "gate_up":
        I, il = args.intermediate_size, args.intermediate_local
        return torch.cat([w[:, rank * il:(rank + 1) * il],
                          w[:, I + rank * il:I + (rank + 1) * il]], dim=1)
    if name == "o":
        return w[rank * args.q_size_local:(rank + 1) * args.q_size_local]
    if name == "down":
        il = args.intermediate_local
        return w[rank * il:(rank + 1) * il]
    raise ValueError(f"no TP layout for {name!r}")


def shard_vocab(w: torch.Tensor, args, rank: int) -> torch.Tensor:
    """Rank `rank`'s vocab columns of the lm_head [E, V]. Both lm_head forms
    quantize per output column, so a shard's W8 equals the global W8's
    columns."""
    if args.tp_size == 1:
        return w
    v = args.vocab_local
    return w[:, rank * v:(rank + 1) * v].contiguous()


def quantize_params_tp(float_params: dict, args, rank: int, device="cuda"):
    """Rank `rank`'s LlamaParams of float weights (the JAX package's
    random_float_params layout, dense or MoE), each shard quantized on its
    own as the JAX package's quantize_params_tp does."""
    from qserve_tpu_torch.models import llama, mixtral

    moe = "router" in float_params["layers"][0]
    return (mixtral if moe else llama).quantize_params(float_params, args, device, rank=rank)


def random_quantized_params_tp(seed: int, args, rank: int, device="cuda"):
    """Rank `rank`'s share of random_quantized_params(seed, args): the same
    full-layer float tensors drawn in the same order from the same
    generator, each sharded and quantized on the device layer by layer, so
    the float model never exists whole. At tp = 1 it is
    random_quantized_params bit for bit."""
    from qserve_tpu_torch.models import llama, mixtral

    build = mixtral if args.num_experts else llama
    return build.random_quantized_params(seed, args, device, rank=rank)
