"""Large-scale VLM captioning over webdataset tar shards
(qserve_tpu/entrypoints/vila_caption.py).

One JSON of {sample key: caption} per tar shard, written when the shard is
done; a shard whose JSON exists is skipped, so a rerun resumes. Shards are
split across DP workers by --worker-id / --num-workers (or the WORKER_ID /
NUM_WORKERS environment), and requests are batched max_num_seqs at a time.
Runs on the card unless --device cpu is given.

  python -m qserve_tpu_torch.entrypoints.vila_caption --model <vila_dir> \
      --precision w8a8kv8 --data-path 'shards/cc-{00000..00099}.tar' \
      --output-path caps/ [--worker-id 0 --num-workers 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time


DEFAULT_PROMPT = "<image>\n Can you describe the image?"


def add_args(parser):
    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    EngineArgs.add_cli_args(parser)
    parser.add_argument("--data-path", type=str, required=True,
                        help="tar shard glob or brace pattern")
    parser.add_argument("--output-path", type=str, required=True)
    parser.add_argument("--caption-prompt", type=str, default=DEFAULT_PROMPT)
    parser.add_argument("--max-tokens", type=int, default=96)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--worker-id", type=int,
                        default=int(os.environ.get("WORKER_ID", "0")))
    parser.add_argument("--num-workers", type=int,
                        default=int(os.environ.get("NUM_WORKERS", "1")))
    return parser


def caption_shard(engine, tar_path, out_path, prompt, sp, batch):
    """Caption one tar shard; returns {key: caption}. Resumable: the caller
    skips shards whose output JSON already exists."""
    from qserve_tpu_torch.utils import webdataset as wds
    from qserve_tpu_torch.utils.image_processing import load_image

    results = {}
    pending = {}

    def drain(blocking):
        while engine.has_unfinished_requests():
            for out in engine.step():
                if out.finished:
                    key = pending.pop(out.request_id)
                    results[key] = out.outputs[0]["text"]
            if not blocking and len(pending) < batch:
                return

    for sample in wds.iter_samples(tar_path):
        img_bytes = wds.first_image(sample)
        if img_bytes is None:
            continue
        rid = f"{tar_path}:{sample['__key__']}"
        pending[rid] = sample["__key__"]
        engine.add_request(
            rid, prompt=prompt, sampling_params=sp,
            multi_modal_data={"images": [load_image(img_bytes)]},
        )
        if len(pending) >= batch:
            drain(blocking=False)
    drain(blocking=True)
    with open(out_path, "w") as f:
        json.dump(results, f)
    return results


def main():
    args = add_args(argparse.ArgumentParser()).parse_args()
    args.run_vlm = True

    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams
    from qserve_tpu_torch.utils import webdataset as wds

    shards = wds.shard_for_worker(
        wds.list_shards(args.data_path), args.worker_id, args.num_workers
    )
    os.makedirs(args.output_path, exist_ok=True)
    engine = EngineArgs.from_cli_args(args).build_engine()
    sp = SamplingParams(max_tokens=args.max_tokens,
                        temperature=args.temperature)

    total = 0
    t0 = time.time()
    for tar_path in shards:
        base = os.path.splitext(os.path.basename(tar_path))[0]
        out_path = os.path.join(args.output_path, base + ".json")
        if os.path.exists(out_path):
            print(f"skip {base} (exists)")
            continue
        res = caption_shard(engine, tar_path, out_path, args.caption_prompt,
                            sp, args.max_num_seqs)
        total += len(res)
        print(f"{base}: {len(res)} captions "
              f"({total / (time.time() - t0):.2f} img/s cumulative)")


if __name__ == "__main__":
    main()
