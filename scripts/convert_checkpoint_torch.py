#!/usr/bin/env python
"""CLI: convert checkpoints to the packed QoQ serving format with the
PyTorch port (qserve_tpu_torch; scripts/convert_checkpoint.py's
counterpart). Either package serves the output.

Usage:
  # self-quantize a local HF fp16/bf16 checkpoint (on the card)
  python scripts/convert_checkpoint_torch.py --model-path /path/llama \
      --output-path /path/out --precision w4a8kv4 --group-size -1

  # the same after activation-aware scale optimization over a byte corpus
  # (a directory holding train.bin, as scripts/build_tiny_corpus.py writes)
  python scripts/convert_checkpoint_torch.py --model-path /path/llama \
      --output-path /path/out --calib-corpus /path/corpus

  # convert DeepCompressor fake-quant output (model.pt + scale.pt), on the host
  python scripts/convert_checkpoint_torch.py --model-path /path/llama \
      --quant-path /path/deepcompressor_out --output-path /path/out \
      --precision w4a8kv4 --group-size 128

Add --device cpu to quantize and optimize on the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True, help="local HF model dir")
    ap.add_argument("--quant-path", default=None,
                    help="DeepCompressor output dir (model.pt + scale.pt); "
                         "omit to self-quantize the fp checkpoint")
    ap.add_argument("--output-path", required=True)
    ap.add_argument("--precision", default="w4a8kv4")
    ap.add_argument("--group-size", type=int, default=-1)
    ap.add_argument("--no-kv-zero-point", dest="kv_zp", action="store_false")
    ap.add_argument("--calib-corpus", default=None,
                    help="corpus dir (train.bin) enabling activation-aware "
                         "scale optimization before RTN (self-quantize only)")
    ap.add_argument("--calib-windows", type=int, default=32)
    ap.add_argument("--calib-seqlen", type=int, default=512)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from qserve_tpu_torch.convert import checkpoint_converter as cc

    if args.quant_path:
        if args.calib_corpus:
            ap.error("--calib-corpus applies to self-quantization only "
                     "(DeepCompressor scales are already optimized)")
        cc.convert_deepcompressor_checkpoint(
            args.model_path, args.quant_path, args.output_path,
            args.precision, args.group_size, args.kv_zp,
        )
    else:
        cc.convert_hf_checkpoint(
            args.model_path, args.output_path, args.precision,
            args.group_size, args.kv_zp, calib_corpus=args.calib_corpus,
            calib_windows=args.calib_windows, calib_seqlen=args.calib_seqlen,
            alpha=args.alpha, device=args.device,
        )
    print(f"wrote packed checkpoint to {args.output_path}")


if __name__ == "__main__":
    main()
