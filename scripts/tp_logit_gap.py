#!/usr/bin/env python3
"""How far tp = 2 logits stray from tp = 1 logits of the same random
weights, and how far a broken TP stray, on the CPU.

    python3 scripts/tp_logit_gap.py [--layers 2 8 32]

A Llama of head dim 128 and GQA 4 (hidden 1024, 8 heads, 2 kv heads,
intermediate 2048, vocab 8192) at W4A8KV4 per-channel, random weights of
seed 0: a packed prefill of two prompts at tp = 1 in this process, and at
tp = 2 in two spawned ranks over gloo (random_quantized_params_tp: the same
float weights, quantized per shard). Prints, for each depth, the relative
RMS gap ||l2 - l1|| / ||l1|| of the last-token logits, the same gap of
W16A16KV8 tp = 1 logits from the W4A8KV4 ones (what W4 quantization itself
moves), the gap at W16A16KV8 between tp = 2 and tp = 1 (no weight scales:
the bf16 rounding of the partial sums alone), the gap of the tp = 2 logits
with the two vocab halves swapped (a gather in the wrong rank order), and
tp = 1's top-2 margins. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _args(layers, precision="w4a8kv4", tp=1):
    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.models import llama

    return llama.LlamaArgs(quant=QuantSpec.from_precision(precision, -1), tp_size=tp,
                           vocab_size=8192, hidden_size=1024, intermediate_size=2048,
                           num_layers=layers, num_heads=8, num_kv_heads=2, head_dim=128)


def _prefill(args, params):
    """Last-token logits [2, V] of two packed prompts (100 and 60 tokens)."""
    import torch

    from qserve_tpu_torch.kernels import kv_cache as kvc
    from qserve_tpu_torch.models import llama

    rng = np.random.default_rng(0)
    T, ps = 192, 16
    tok = np.zeros(T, np.int32)
    tok[:160] = rng.integers(0, args.vocab_size, 160)
    pos = np.concatenate([np.arange(100), np.arange(60), np.zeros(32)])
    seg = np.concatenate([np.ones(100), np.full(60, 2), np.zeros(32)])
    pages = np.concatenate([np.arange(100) // ps, 8 + np.arange(60) // ps, np.full(32, -1)])
    slots = np.concatenate([np.arange(100) % ps, np.arange(60) % ps, np.zeros(32)])
    cache = kvc.create_kv_cache(args.num_layers, 16, args.kv_heads_local, ps, args.head_dim,
                                args.quant.kv_bits,
                                scale_dtype=kvc.scale_dtype_for(args.num_kv_heads),
                                device="cpu")
    x = [torch.from_numpy(np.asarray(a, np.int32)) for a in
         (tok, pos, seg, pages, slots, [99, 159])]
    return llama.prefill(params, cache, *x, args)[0].float().numpy()


def _tp_rank(rank: int, world_size: int, layers: int):
    """This rank's logits at W4A8KV4 and at W16A16KV8."""
    from qserve_tpu_torch.parallel import dryrun, tp as tpmod

    tp_rank, _, _ = dryrun.setup_rank(world_size)
    out = []
    for precision in ("w4a8kv4", "w16a16kv8"):
        args = _args(layers, precision, tp=world_size)
        out.append(_prefill(args, tpmod.random_quantized_params_tp(0, args, tp_rank, "cpu")))
    return out


def _gap(got, want):
    return (np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)).tolist()


def main() -> int:
    import torch

    from qserve_tpu_torch.models import llama
    from qserve_tpu_torch.parallel import distributed

    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, nargs="+", default=[2, 8, 32])
    a = p.parse_args()
    torch.set_num_threads(2)
    rows = []
    for layers in a.layers:
        w4 = _prefill(_args(layers), llama.random_quantized_params(0, _args(layers), "cpu"))
        w16_args = _args(layers, "w16a16kv8")
        w16 = _prefill(w16_args, llama.random_quantized_params(0, w16_args, "cpu"))
        ranks = distributed.spawn(_tp_rank, 2, (layers,), timeout_s=900)
        for a, b in zip(*ranks):
            assert np.array_equal(a, b), "the ranks' logits differ"
        tp2, w16_tp2 = ranks[0]
        V = tp2.shape[1]
        swapped = np.concatenate([tp2[:, V // 2:], tp2[:, :V // 2]], 1)
        top = np.sort(w4, 1)
        row = dict(layers=layers, tp2_gap=_gap(tp2, w4), w16_gap=_gap(w16, w4),
                   w16_tp2_gap=_gap(w16_tp2, w16),
                   swapped_gap=_gap(swapped, w4),
                   top2_margin=(top[:, -1] - top[:, -2]).tolist(),
                   logit_std=w4.std(1).tolist(),
                   argmax_equal=int((tp2.argmax(1) == w4.argmax(1)).sum()))
        print(row, flush=True)
        rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
