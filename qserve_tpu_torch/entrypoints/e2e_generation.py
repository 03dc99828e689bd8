"""Batch chat generation (qserve_tpu/entrypoints/e2e_generation.py).

Feeds prompts through the model's conversation template, adds them all,
then drives the in-flight-batching step loop to completion. The default
sampling (temperature 0.7, top-p 0.9) runs the filtered sampler.

  python -m qserve_tpu_torch.entrypoints.e2e_generation --model <hf dir> \
      [--quant-path <packed dir>] --precision w4a8kv4 \
      [--prompts-file f.txt | --prompt "..."] [--device cpu]
"""

from __future__ import annotations

import argparse

DEFAULT_PROMPTS = [
    "What is the capital of France?",
    "Explain the difference between a process and a thread.",
    "Write a haiku about the ocean.",
    "List three uses of binary search.",
]


def main():
    from qserve_tpu_torch.conversation import get_conv_template, get_conv_template_name
    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams

    parser = EngineArgs.add_cli_args(argparse.ArgumentParser())
    parser.add_argument("--prompt", action="append", default=None)
    parser.add_argument("--prompts-file", type=str, default=None)
    parser.add_argument("--max-tokens", type=int, default=256)
    parser.add_argument("--temperature", type=float, default=0.7)
    parser.add_argument("--top-p", type=float, default=0.9)
    parser.add_argument("--conv-template", type=str, default=None)
    args = parser.parse_args()

    prompts = args.prompt or []
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [line.strip() for line in f if line.strip()]
    if not prompts:
        prompts = DEFAULT_PROMPTS

    engine_args = EngineArgs.from_cli_args(args)
    engine = engine_args.build_engine()

    tname = args.conv_template or get_conv_template_name(args.model)
    for i, user_msg in enumerate(prompts):
        conv = get_conv_template(tname)
        conv.append_message(conv.roles[0], user_msg)
        conv.append_message(conv.roles[1], None)
        engine.add_request(
            str(i),
            prompt=conv.get_prompt(),
            sampling_params=SamplingParams(
                max_tokens=args.max_tokens,
                temperature=args.temperature,
                top_p=args.top_p,
                stop=conv.stop_str,
            ),
        )

    finished = 0
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                finished += 1
                print(f"\n=== request {out.request_id} ===")
                print(f"[prompt] {prompts[int(out.request_id)]}")
                print(f"[output] {out.outputs[0]['text']}")
    assert finished == len(prompts), f"{finished} != {len(prompts)}"
    print(f"\nfinished {finished} requests; stats: {engine.stats()}")


if __name__ == "__main__":
    main()
