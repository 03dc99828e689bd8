"""Offline synthetic throughput benchmark of the port
(qserve_tpu/entrypoints/benchmark.py).

GLOBAL_BATCH_SIZE requests of fixed prompt/generation lengths with random
token ids, run for N rounds; prints and appends output tok/s to a CSV.

  python -m qserve_tpu_torch.entrypoints.benchmark --model <dir with config.json> \
      --random-weights --precision w4a8kv4 [--group-size 128] [--quant-lm-head] \
      [--benchmarking]

`--model` may also hold a float checkpoint (quantized at load), with
`--quant-path` a packed one, in place of `--random-weights`. With
`--benchmarking` a stable decode batch feeds its sampled ids back on the
device (worker/model_runner.py) and the engine sees placeholder ids. Each
CSV row names the precision, the W4 group size, the lm_head bits and
whether the decode was device-fed.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np


def add_args(parser):
    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    EngineArgs.add_cli_args(parser)
    parser.add_argument("--prompt-len", type=int,
                        default=int(os.environ.get("PROMPT_LEN", "1024")))
    parser.add_argument("--generation-len", type=int,
                        default=int(os.environ.get("GENERATION_LEN", "512")))
    parser.add_argument("--global-batch-size", type=int,
                        default=int(os.environ.get("GLOBAL_BATCH_SIZE", "32")))
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--results-csv", type=str, default="results_torch.csv")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="trace round 1 (or the only round) with "
                             "torch.profiler; write the per-kernel device "
                             "time summary here")
    return parser


def _sync(engine) -> None:
    import torch

    if engine.worker.model_runner.device.type == "cuda":
        torch.cuda.synchronize()


def device_time_summary(prof, wall_s: float, top: int = 20) -> str:
    """Per-kernel device time of a torch.profiler run, and the share of the
    wall time the device was busy (one stream: kernels do not overlap).
    Only device-side events count: an operator's row repeats the time of
    the kernels it launched."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    lines = [f"device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms wall "
             f"({100 * busy_ms / (wall_s * 1e3):.1f}%)"]
    for us, n, name in rows[:top]:
        lines.append(f"{us / 1e3:10.2f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
                     f"{n:7d} calls  {name[:90]}")
    return "\n".join(lines)


def run(engine, vocab_size, batch, prompt_len, gen_len, rounds, csv_path,
        profile_dir=None):
    import contextlib

    from qserve_tpu_torch.sampling_params import SamplingParams

    rng = np.random.default_rng(0)
    quant = engine.worker.model_runner.model_args.quant
    rows = []
    for rnd in range(rounds):
        prof = None
        if profile_dir is not None and rnd == min(1, rounds - 1):
            import torch.profiler as tp

            prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                          tp.ProfilerActivity.CUDA])
        prof_cm = prof if prof is not None else contextlib.nullcontext()
        for i in range(batch):
            toks = rng.integers(4, vocab_size - 1, prompt_len).tolist()
            engine.add_request(
                f"r{rnd}-{i}",
                prompt_token_ids=toks,
                sampling_params=SamplingParams(
                    max_tokens=gen_len, temperature=0.0, ignore_eos=True
                ),
            )
        _sync(engine)
        t0 = time.perf_counter()
        finished = 0
        gen_tokens = 0
        step_ms = {"prefill": [], "mixed": [], "decode": []}
        with prof_cm:
            while engine.has_unfinished_requests():
                ts = time.perf_counter()
                for out in engine.step():
                    if out.finished:
                        finished += 1
                        gen_tokens += sum(len(o["token_ids"]) for o in out.outputs)
                # what the scheduler emitted: prompt tokens only (a chunk
                # alone counts as prefill), a chunk with decode rows riding
                # along, or decode rows only
                kind = {"chunk": "prefill"}.get(
                    engine.last_step_kind, engine.last_step_kind
                )
                if kind is not None:
                    step_ms[kind].append((time.perf_counter() - ts) * 1e3)
            _sync(engine)
        dt = time.perf_counter() - t0
        if prof is not None:
            summary = device_time_summary(prof, dt)
            print(summary)
            os.makedirs(profile_dir, exist_ok=True)
            with open(os.path.join(profile_dir, f"round{rnd}_device_time.txt"), "w") as f:
                f.write(summary + "\n")
        tput = gen_tokens / dt
        pre = float(np.mean(step_ms["prefill"])) if step_ms["prefill"] else 0.0
        mix = float(np.mean(step_ms["mixed"])) if step_ms["mixed"] else 0.0
        dec = float(np.median(step_ms["decode"])) if step_ms["decode"] else 0.0
        print(f"round {rnd}: {finished} seqs, {gen_tokens} tokens, "
              f"{dt:.2f}s, {tput:.1f} tok/s; {len(step_ms['prefill'])} prefill "
              f"steps, mean {pre:.2f} ms; {len(step_ms['mixed'])} mixed steps, "
              f"mean {mix:.2f} ms; {len(step_ms['decode'])} decode steps, "
              f"median {dec:.2f} ms")
        rows.append(dict(precision=quant.precision, group_size=quant.group_size,
                         lm_head_bits=quant.lm_head_bits,
                         device_feed=engine.worker.model_runner.benchmarking,
                         round=rnd, batch=batch, prompt_len=prompt_len,
                         generation_len=gen_len, seconds=dt, tokens_per_s=tput,
                         prefill_step_ms_mean=pre, decode_step_ms_median=dec,
                         mixed_steps=len(step_ms["mixed"]),
                         mixed_step_ms_mean=mix))
    if not any(r["mixed_steps"] for r in rows):
        # the mixed column pair appears only when the run had such steps
        for r in rows:
            del r["mixed_steps"], r["mixed_step_ms_mean"]
    if csv_path:
        exists = os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if not exists:
                w.writeheader()
            w.writerows(rows)
    return rows


def main():
    parser = add_args(argparse.ArgumentParser())
    args = parser.parse_args()
    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    engine = EngineArgs.from_cli_args(args).build_engine()
    vocab = engine.worker.model_runner.model_args.vocab_size
    run(engine, vocab, args.global_batch_size, args.prompt_len,
        args.generation_len, args.rounds, args.results_csv,
        profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
