"""VLM throughput benchmark (qserve_tpu/entrypoints/benchmark_image.py).

Synthetic workload: each request carries img_per_seq random images (PIL,
from numpy) plus a 24-id text prompt; prints end-to-end tokens/s and
image-sequences/s a round. The engine expands each image to the
projector's tokens_per_image markers. Runs on the card unless --device cpu
is given.

  python -m qserve_tpu_torch.entrypoints.benchmark_image --model <dir> \
      --random-weights [--precision w8a8kv8] [--img-per-seq 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main():
    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams
    from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX

    parser = EngineArgs.add_cli_args(argparse.ArgumentParser())
    parser.add_argument("--global-batch-size", type=int,
                        default=int(os.environ.get("GLOBAL_BATCH_SIZE", "16")))
    parser.add_argument("--generation-len", type=int, default=64)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    args.run_vlm = True

    engine = EngineArgs.from_cli_args(args).build_engine()
    runner = engine.worker.model_runner
    image_size = runner.vila_args.vision.image_size
    vocab = runner.model_args.vocab_size

    rng = np.random.default_rng(0)

    def synth_image():
        from PIL import Image

        return Image.fromarray(
            rng.integers(0, 255, (image_size, image_size, 3), np.uint8)
        )

    for rnd in range(args.rounds):
        for i in range(args.global_batch_size):
            text = rng.integers(4, vocab - 1, 24).tolist()
            ids = text[:4] + [IMAGE_TOKEN_INDEX] * args.img_per_seq + text[4:]
            engine.add_request(
                f"r{rnd}-{i}", prompt_token_ids=ids,
                sampling_params=SamplingParams(
                    max_tokens=args.generation_len, temperature=0.0,
                    ignore_eos=True,
                ),
                multi_modal_data={
                    "images": [synth_image() for _ in range(args.img_per_seq)]
                },
            )
        t0 = time.time()
        finished = gen_tokens = 0
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    finished += 1
                    gen_tokens += sum(len(o["token_ids"]) for o in out.outputs)
        dt = time.time() - t0
        print(f"round {rnd}: {finished} seqs, {gen_tokens} tokens, {dt:.2f}s, "
              f"{gen_tokens/dt:.1f} tok/s, {finished/dt:.2f} img-seqs/s")


if __name__ == "__main__":
    main()
