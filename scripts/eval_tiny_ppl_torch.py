"""Measure ΔPPL(FP16 -> QoQ) of a byte-level model with the PyTorch port
(qserve_tpu_torch; scripts/eval_tiny_ppl.py's counterpart).

The accuracy counterpart of the reference's WikiText-2 table
(README.md:371-389): for each precision, load the SAME HF checkpoint through
the port's loader and self-quantizer, run the serving forward
(teacher_forced_nll: the quantized GEMMs and the prefill attention kernel
on the card) over held-out text, and report PPL. KV quantization is
simulated in attention (the PPL forward has no decode KV cache), so the
numbers cover the full W4A8KV4 claim.

Usage:
  python scripts/eval_tiny_ppl_torch.py CKPT_DIR CORPUS_DIR \
      [--seqlen 512] [--windows 64] [--optimize] [--device cpu]

CKPT_DIR is an HF directory with a vocabulary of more than 256 ids (byte
ids and BOS 256), such as scripts/train_tiny_lm.py writes; CORPUS_DIR holds
val.bin (and train.bin for --optimize), as scripts/build_tiny_corpus.py
writes.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

BOS = 256


def evaluate(params, args_m, tokens, seqlen, windows, kv_sim, row_chunk=128):
    """(ppl, windows scored) over non-overlapping seqlen windows."""
    import torch

    from qserve_tpu_torch.models import llama

    device = params.embed.device
    total_nll, total_cnt = 0.0, 0
    n = min(windows, len(tokens) // seqlen)
    for w in range(n):
        toks = torch.from_numpy(np.ascontiguousarray(
            tokens[w * seqlen : (w + 1) * seqlen], np.int32)).to(device)
        nll, cnt = llama.teacher_forced_nll(params, toks, seqlen, args_m, row_chunk,
                                            simulate_kv_quant=kv_sim)
        total_nll += float(nll)
        total_cnt += cnt
    return math.exp(total_nll / max(total_cnt, 1)), n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("corpus_dir")
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--windows", type=int, default=64)
    ap.add_argument(
        "--optimize", action="store_true",
        help="also evaluate activation-aware optimized scales "
        "(quant/optimize.py: SmoothQuant+SmoothAttention folds + clip search) "
        "next to plain RTN for each 4-bit flavor",
    )
    ap.add_argument("--calib-windows", type=int, default=32)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument(
        "--lm-head8", action="store_true",
        help="also evaluate each quantized config with the W8 per-channel "
        "lm_head (quant.lm_head_bits=8) next to the bf16 lm_head",
    )
    ap.add_argument(
        "--alpha-sweep", type=str, default=None,
        help="comma-separated alphas; evaluates ONLY the +opt 4-bit configs "
        "at each alpha (RTN + FP16 once) and reports the best per flavor",
    )
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.models import llama, loader

    val = np.fromfile(os.path.join(args.corpus_dir, "val.bin"), np.uint8)
    tokens = val.astype(np.int32)
    print(f"val corpus: {len(tokens)} tokens")

    cfg = loader.load_hf_config_dict(args.ckpt_dir)
    fp = None
    # (group_size, alpha) -> optimized float params (clip is gs-dependent)
    fp_opt = {}
    calib = None
    results = {}
    configs = [
        ("w16a16kv8", -1, False, None, 16, "FP16 (baseline)"),
        ("w8a8kv8", -1, True, None, 16, "W8A8KV8"),
        ("w4a8kv4", -1, True, None, 16, "W4A8KV4 per-channel"),
        ("w4a8kv4", 128, True, None, 16, "W4A8KV4 g128"),
    ]
    if args.lm_head8:
        configs += [
            ("w8a8kv8", -1, True, None, 8, "W8A8KV8 +lmh8"),
            ("w4a8kv4", -1, True, None, 8, "W4A8KV4 per-channel +lmh8"),
            ("w4a8kv4", 128, True, None, 8, "W4A8KV4 g128 +lmh8"),
        ]
    if args.alpha_sweep:
        for a in (float(a) for a in args.alpha_sweep.split(",")):
            configs += [
                ("w4a8kv4", -1, True, a, 16, f"W4A8KV4 per-channel +opt a={a}"),
                ("w4a8kv4", 128, True, a, 16, f"W4A8KV4 g128 +opt a={a}"),
            ]
    elif args.optimize:
        configs += [
            ("w4a8kv4", -1, True, args.alpha, 16, "W4A8KV4 per-channel +opt"),
            ("w4a8kv4", 128, True, args.alpha, 16, "W4A8KV4 g128 +opt"),
        ]
    for precision, gs, kv_sim, alpha, lmh, label in configs:
        quant = QuantSpec.from_precision(precision, gs, lm_head_bits=lmh)
        margs = loader.args_from_config_dict(cfg, quant)
        if fp is None:
            fp = loader.load_float_params_from_hf(args.ckpt_dir, margs)
        t0 = time.time()
        src = fp
        if alpha is not None:
            if (gs, alpha) not in fp_opt:
                from qserve_tpu_torch.quant import optimize

                if calib is None:
                    calib = optimize.load_calib_windows(
                        args.corpus_dir, n_windows=args.calib_windows,
                        seqlen=args.seqlen, bos=BOS,
                    )
                fp_opt[(gs, alpha)] = optimize.optimize_float_params(
                    fp, margs, calib, alpha=alpha, alpha_attn=alpha, device=args.device,
                )
            src = fp_opt[(gs, alpha)]
        params = llama.quantize_params(src, margs, device=args.device)
        ppl, n = evaluate(params, margs, tokens, args.seqlen, args.windows, kv_sim)
        results[label] = ppl
        print(
            f"{label:<26} ppl {ppl:8.4f}   ({n} windows x {args.seqlen}, "
            f"{time.time() - t0:5.1f}s)",
            flush=True,
        )
    base = results["FP16 (baseline)"]
    for label, ppl in results.items():
        if label != "FP16 (baseline)":
            print(f"Δppl {label:<26} {ppl - base:+.4f}  (relative {ppl / base - 1:+.2%})")
    return results


if __name__ == "__main__":
    main()
