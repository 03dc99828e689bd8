"""How close RTN and activation-aware optimized W4A8KV4 come to W16A16 on a
random-weight model whose embedding has outlier columns, read two ways.

The model: 2 layers at hidden --hidden (head_dim 128, intermediate 3.5x,
a byte vocabulary of 512 ids), bf16 random weights of std 0.02 drawn from
a seed, norm weights around 1, and 5% of the embedding's columns times
--boost (tests/test_quant_optimize.py's regime). The optimizer calibrates
on 32 x 512 windows of the JAX package's source bytes (train split, the
first 90%); the held-out windows come from the rest.

For RTN and for the optimized model at each --alpha:
  * logits: relative RMS error of the quantized model's logits against
    W16A16's on one held-out window (the JAX package's test metric);
  * bytes: teacher-forced NLL sum over 4 held-out windows minus W16A16's.
    Held-out bytes are unrelated to a random model, so this reads how far
    the logits' spread moved, of either sign. (chip_smoke.py's phase
    offline scores sequences the W16A16 model sampled instead, where the
    gap estimates the KL divergence.)

Usage: python scripts/optimize_fidelity.py [--hidden 1024] [--boost 30]
    [--alpha 0.5 0.25] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus_bytes() -> bytes:
    """The JAX package's *.py files (qserve_tpu/, which the port never
    edits, so the corpus is the same in every checkout), sorted."""
    out = []
    for dirpath, dirnames, files in os.walk(os.path.join(ROOT, "qserve_tpu")):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith((".", "__")))
        for f in sorted(files):
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out.append(fh.read())
    return b"\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--boost", type=float, default=30.0)
    ap.add_argument("--alpha", type=float, nargs="+", default=[0.5])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.kernels import attention, ops
    from qserve_tpu_torch.layers import rope
    from qserve_tpu_torch.models import llama
    from qserve_tpu_torch.quant import optimize
    from qserve_tpu_torch.utils.utils import resolve_device

    dev = resolve_device(args.device)
    E, V, T = args.hidden, 512, 512
    geo = dict(vocab_size=V, hidden_size=E, intermediate_size=E * 7 // 2, num_layers=2,
               num_heads=E // 128, num_kv_heads=max(1, E // 512), head_dim=128,
               rope_theta=5e5, rms_eps=1e-5)
    a4 = llama.LlamaArgs(**geo, quant=QuantSpec.from_precision("w4a8kv4", -1))
    a16 = llama.LlamaArgs(**geo, quant=QuantSpec.from_precision("w16a16kv8", -1))
    g = torch.Generator().manual_seed(8)

    def rnd(*shape, scale=0.02, base=0.0):
        return (base + scale * torch.randn(shape, generator=g)).to(torch.bfloat16).float()

    def ln():
        return rnd(E, scale=0.1, base=1.0)

    fp = dict(embed=rnd(V, E), final_ln=ln(), lm_head=rnd(E, V), layers=[
        dict(input_ln=ln(), post_ln=ln(), qkv=rnd(E, a4.qkv_out), o=rnd(a4.q_size, E),
             gate_up=rnd(E, 2 * a4.intermediate_size), down=rnd(a4.intermediate_size, E))
        for _ in range(2)])
    chan = torch.rand(E, generator=torch.Generator().manual_seed(99)) < 0.05
    fp["embed"] = fp["embed"] * torch.where(chan, args.boost, 1.0)[None, :]

    raw = corpus_bytes()
    cut = len(raw) * 9 // 10
    with tempfile.TemporaryDirectory() as corpus:
        np.frombuffer(raw[:cut], np.uint8).tofile(os.path.join(corpus, "train.bin"))
        calib = optimize.load_calib_windows(corpus, n_windows=32, seqlen=T)
    val = np.frombuffer(raw[cut:], np.uint8).astype(np.int32)
    held = [torch.from_numpy(val[i * T:(i + 1) * T].copy()).to(dev) for i in range(4)]

    def logits(p, a, tok):
        n = len(tok)
        h = p.embed[tok.long()].to(torch.bfloat16)
        cos, sin = rope.rope_cos_sin(torch.arange(n, dtype=torch.int32, device=dev),
                                     a.head_dim, a.rope_theta)
        seg = torch.ones(n, dtype=torch.int32, device=dev)
        h, _ = llama._run_layers(p, h, cos, sin, a,
                                 lambda q, k, v, _li: attention.prefill_attention(q, k, v, seg))
        return ops.matmul(ops.rmsnorm(h, p.final_ln, a.rms_eps), p.lm_head, torch.float32)

    p16 = llama.quantize_params(fp, a16, device=dev)
    ref = logits(p16, a16, held[0])

    def nll(p, a):
        return sum(float(llama.teacher_forced_nll(p, w, len(w), a)[0]) for w in held)

    base = nll(p16, a16)

    def report(name, src):
        p = llama.quantize_params(src, a4, device=dev)
        rel = (((logits(p, a4, held[0]) - ref) ** 2).mean() / (ref**2).mean()).sqrt().item()
        print(f"{name:<16} logits rel RMS {rel:.4f}  NLL gap on held-out bytes "
              f"{nll(p, a4) - base:+.2f}", flush=True)

    print(f"hidden {E}, boost {args.boost}, {args.device}: W16A16 NLL on held-out bytes "
          f"{base:.2f}")
    report("RTN", fp)
    for alpha in args.alpha:
        opt = optimize.optimize_float_params(fp, a4, calib, alpha=alpha, alpha_attn=alpha,
                                             device=dev)
        report(f"optimized a={alpha}", opt)


if __name__ == "__main__":
    main()
