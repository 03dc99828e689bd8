"""Tensor-parallel model runner: one rank's share of the engine's steps
(qserve_tpu/worker/tp_runner.py).

The JAX package's TPModelRunner drives one SPMD program over a (dp, tp)
mesh. Here each rank is one process (parallel/distributed.py) running the
whole engine, replicated: the same scheduler on the same requests, with
this rank's params (parallel/tp.py: per-shard quantization) and a cache of
its own kv heads. The steps are the single-device runner's prefill, chunk,
mixed and decode steps over args with tp_size set, whose layers reduce o and
down over the TP group and gather the logits' vocab columns. Every rank
then samples the same gathered logits with the same generator state (the
device generator, the host (seed, offset) generator of the filtered
sampler's Philox noise, and the host generator of best_of's extra
candidates, all seeded alike), so every rank gets the same ids.

The device-fed decode (`benchmarking`) is not used, as in the JAX package,
whose TPModelRunner.execute_decode overrides it.
"""

from __future__ import annotations

import dataclasses

from qserve_tpu_torch.models import llama
from qserve_tpu_torch.parallel import tp as tpmod
from qserve_tpu_torch.worker.model_runner import ModelRunner


class TPModelRunner(ModelRunner):
    """ModelRunner over one rank's shard; the collectives run in the
    model's layers."""

    def __init__(
        self,
        params: llama.LlamaParams,
        model_args: llama.LlamaArgs,
        max_model_len: int,
        block_size: int,
        tp_size: int,
        dp_size: int = 1,
        max_num_batched_tokens: int = 2048,
        max_num_seqs: int = 256,
        rng_seed: int = 0,
        device="cuda",
    ) -> None:
        # dp > 1 inside ONE engine needs per-replica request routing; serve
        # with one engine per dp replica instead (the JAX package's reason,
        # qserve_tpu/worker/tp_runner.py:60)
        assert dp_size == 1, "engine-level dp>1: run one engine per replica"
        assert tpmod.tp_world() == tp_size, (
            f"the TP group has {tpmod.tp_world()} ranks, tp_size is {tp_size}")
        args = dataclasses.replace(model_args, tp_size=tp_size)
        super().__init__(
            params, args, max_model_len, block_size,
            max_num_batched_tokens=max_num_batched_tokens,
            max_num_seqs=max_num_seqs, rng_seed=rng_seed, device=device,
            benchmarking=False,
        )
        self.tp_size = tp_size
        self.tp_rank = tpmod.tp_rank()

    @classmethod
    def from_float_tp(cls, float_params: dict, model_args, max_model_len, block_size,
                      tp_size: int, device="cuda", **kw) -> "TPModelRunner":
        """This rank's shards of float weights (the JAX package's
        random_float_params layout, or a loaded HF checkpoint's)."""
        args = dataclasses.replace(model_args, tp_size=tp_size)
        params = tpmod.quantize_params_tp(float_params, args, tpmod.tp_rank(), device)
        return cls(params, args, max_model_len, block_size, tp_size, device=device, **kw)

    @classmethod
    def from_random_tp(cls, model_args, max_model_len, block_size, tp_size: int,
                       seed: int = 0, device="cuda", **kw) -> "TPModelRunner":
        """This rank's share of random_quantized_params(seed, model_args)."""
        args = dataclasses.replace(model_args, tp_size=tp_size)
        params = tpmod.random_quantized_params_tp(seed, args, tpmod.tp_rank(), device)
        return cls(params, args, max_model_len, block_size, tp_size,
                   rng_seed=seed, device=device, **kw)
