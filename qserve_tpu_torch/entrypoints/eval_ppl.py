"""WikiText-2 perplexity evaluation entry point
(qserve_tpu/entrypoints/eval_ppl.py).

The reference delegates accuracy to DeepCompressor (README.md:371-389;
protocol: concatenated corpus, eval seqlen 2048, non-overlapping windows).
This runs the quantized serving path over the same protocol and, with
--baseline, the W16A16KV8 model too:

  python -m qserve_tpu_torch.entrypoints.eval_ppl --model <dir> \
      --precision w4a8kv4 --group-size -1 --data wikitext2.txt \
      [--baseline] [--device cpu]

Prints one JSON line: precision, group_size, seqlen, ppl (and ppl_fp16,
delta with --baseline).
"""

from __future__ import annotations

import argparse
import json


def load_corpus_text(path: str) -> str:
    """A plain-text file, or a HF datasets dir/name if datasets is importable
    and the data is available locally (no network)."""
    import os

    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            return f.read()
    # HF datasets from the local cache (e.g. "wikitext:wikitext-2-raw-v1:test")
    parts = path.split(":")
    from datasets import load_dataset  # type: ignore

    name = parts[0]
    config = parts[1] if len(parts) > 1 else None
    split = parts[2] if len(parts) > 2 else "test"
    ds = load_dataset(name, config, split=split)
    return "\n\n".join(ds["text"])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True, help="local HF model dir")
    p.add_argument("--precision", type=str, default="w4a8kv4")
    p.add_argument("--group-size", type=int, default=-1)
    p.add_argument("--quant-path", type=str, default=None)
    p.add_argument("--data", type=str, required=True,
                   help="plain-text corpus file or datasets spec name:config:split")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--max-windows", type=int, default=None)
    p.add_argument("--baseline", action="store_true",
                   help="also evaluate w16a16 and report the PPL delta")
    p.add_argument("--device", type=str, default="cuda")
    cli = p.parse_args(argv)

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.eval.ppl import evaluate_ppl, tokenize_text
    from qserve_tpu_torch.models import loader
    from qserve_tpu_torch.utils.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(cli.model)
    text = load_corpus_text(cli.data)
    ids = tokenize_text(tokenizer, text)
    print(f"corpus: {len(ids)} tokens, {len(ids) // cli.seqlen} windows")

    quant = QuantSpec.from_precision(cli.precision, cli.group_size)
    args, params = loader.load_model(cli.model, quant, quant_path=cli.quant_path,
                                     device=cli.device)
    ppl = evaluate_ppl(params, args, ids, cli.seqlen, cli.max_windows,
                       progress=True)
    result = {"precision": quant.precision, "group_size": cli.group_size,
              "seqlen": cli.seqlen, "ppl": round(ppl, 4)}

    if cli.baseline:
        del params
        fq = QuantSpec.from_precision("w16a16kv8", -1)
        fargs, fparams = loader.load_model(cli.model, fq, device=cli.device)
        fppl = evaluate_ppl(fparams, fargs, ids, cli.seqlen, cli.max_windows,
                            progress=True)
        result["ppl_fp16"] = round(fppl, 4)
        result["delta"] = round(ppl - fppl, 4)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
