"""LLM caption distillation over caption JSON shards
(qserve_tpu/entrypoints/caption_rewrite.py).

Reads the per-shard caption JSONs that vila_caption writes, rewrites each
caption through an instruction prompt, and writes one rewritten JSON a
shard (a shard whose output exists is skipped). Runs on the card unless
--device cpu is given.

  python -m qserve_tpu_torch.entrypoints.caption_rewrite --model <llm_dir> \
      --precision w4a8kv4 --input-path caps/ --output-path caps_rw/ [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

DEFAULT_INSTRUCTION = (
    "Rewrite the following image caption as one concise, fluent sentence. "
    "Caption: {caption}\nRewritten:"
)


def main():
    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams

    parser = EngineArgs.add_cli_args(argparse.ArgumentParser())
    parser.add_argument("--input-path", type=str, required=True)
    parser.add_argument("--output-path", type=str, required=True)
    parser.add_argument("--instruction", type=str, default=DEFAULT_INSTRUCTION)
    parser.add_argument("--max-tokens", type=int, default=96)
    args = parser.parse_args()

    engine = EngineArgs.from_cli_args(args).build_engine()
    sp = SamplingParams(max_tokens=args.max_tokens, temperature=0.0)
    os.makedirs(args.output_path, exist_ok=True)

    for path in sorted(glob.glob(os.path.join(args.input_path, "*.json"))):
        out_path = os.path.join(args.output_path, os.path.basename(path))
        if os.path.exists(out_path):
            print(f"skip {os.path.basename(path)} (exists)")
            continue
        with open(path) as f:
            captions = json.load(f)
        pending = {}
        for key, cap in captions.items():
            rid = f"{path}:{key}"
            pending[rid] = key
            engine.add_request(
                rid, prompt=args.instruction.format(caption=cap),
                sampling_params=sp,
            )
        rewritten = {}
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    rewritten[pending[out.request_id]] = out.outputs[0]["text"]
        with open(out_path, "w") as f:
            json.dump(rewritten, f)
        print(f"{os.path.basename(path)}: {len(rewritten)} rewritten")


if __name__ == "__main__":
    main()
