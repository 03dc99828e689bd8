"""Exercise the port's DeepCompressor import path end to end
(qserve_tpu_torch; scripts/deepcompressor_roundtrip.py's counterpart).

Synthesizes a DeepCompressor-format fake-quant artifact (model.pt with
already-rounded float weights + scale.pt with s1 scales and signed zeros,
reference scripts/ckpt_converter/checkpoint_converter.py:81-134
conventions) from an HF checkpoint, runs convert_deepcompressor_checkpoint
on it, loads the packed result, and compares it with the self-quantized
(RTN) path. The synthetic scales ARE the RTN scales (the port's own
quantizers make them), so the importer must recover RTN's integer lattice:
the script prints the share of equal codes and asserts the two PPLs within
2%, as the JAX package's script does.

Kinds: w4chn (W4A8KV4 per-channel, asymmetric zeros stored signed, which
exercises the reference's +8 fold), w4grp (W4A8KV4 g128: s1, integer s2
and z2) and w8 (W8A8KV8, symmetric).

Usage: python scripts/deepcompressor_roundtrip_torch.py CKPT CORPUS \
    [--kind w4chn|w4grp|w8] [--windows 8] [--seqlen 512] [--device cpu]
CORPUS holds val.bin (byte ids; CKPT's vocabulary must exceed 256 ids).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

# kind -> (precision, group size)
KINDS = {"w4chn": ("w4a8kv4", -1), "w4grp": ("w4a8kv4", 128), "w8": ("w8a8kv8", -1)}
_LINEARS = ("self_attn", "mlp.")


def make_artifact(ckpt_dir: str, out_dir: str, kind: str = "w4chn", device="cpu") -> None:
    """HF checkpoint -> DeepCompressor-style model.pt + scale.pt on the
    lattice of `kind`, quantized on `device` by the port's RTN quantizers.
    Linear weights are stored as f32 fake-quant [OC, IC]; every other tensor
    as the checkpoint stores it."""
    import torch

    from qserve_tpu_torch.quant import qoq
    from qserve_tpu_torch.utils.utils import resolve_device
    from qserve_tpu_torch.utils.weight_utils import hf_model_weights_iterator

    dev = resolve_device(device)
    state, scales = {}, {}
    for name, w in hf_model_weights_iterator(ckpt_dir):
        if not (name.endswith(".weight") and any(s in name for s in _LINEARS)):
            state[name] = w
            continue
        wt = w.to(device=dev, dtype=torch.float32).T  # [K, N] = [IC, OC]
        if kind == "w4chn":
            p = qoq.quantize_weight_per_channel(wt)
            zero_u = torch.round(p.s1_szero / p.s1_scale)  # integers 0..15
            fake = qoq.dequantize_per_channel(p)
            scales[name + ".scale"] = p.s1_scale
            scales[name + ".zero"] = zero_u - 8.0  # signed convention
        elif kind == "w4grp":
            p = qoq.quantize_weight_per_group(wt, 128)
            fake = qoq.dequantize_per_group(p, 128)
            scales[name + ".scale"] = p.s1_scale
            scales[name + ".scale2"] = (p.s2_scale.to(torch.int32) & 0xFF).to(torch.float32)
            scales[name + ".zero"] = p.s2_zero.to(torch.float32)
        elif kind == "w8":
            p = qoq.quantize_weight_w8(wt)
            fake = qoq.dequantize_w8(p)
            scales[name + ".scale"] = p.scale
        else:
            raise ValueError(f"kind {kind!r}: one of {sorted(KINDS)}")
        state[name] = fake.T.contiguous().cpu()
    scales = {k: v.cpu() for k, v in scales.items()}
    torch.save(state, os.path.join(out_dir, "model.pt"))
    torch.save(scales, os.path.join(out_dir, "scale.pt"))


def codes_equal_share(a, b) -> float:
    """Share of equal integer codes (W4 nibble bytes or W8 bytes) of two
    packed models' linears."""
    import torch

    got = torch.cat([getattr(a.layers, n).qweight.reshape(-1).cpu()
                     for n in ("qkv", "o", "gate_up", "down")])
    want = torch.cat([getattr(b.layers, n).qweight.reshape(-1).cpu()
                      for n in ("qkv", "o", "gate_up", "down")])
    return (got == want).double().mean().item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("corpus_dir")
    ap.add_argument("--kind", choices=sorted(KINDS), default="w4chn")
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.convert import checkpoint_converter as cc
    from qserve_tpu_torch.models import loader

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eval_tiny_ppl_torch import evaluate

    precision, gs = KINDS[args.kind]
    tokens = np.fromfile(os.path.join(args.corpus_dir, "val.bin"), np.uint8).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "artifact")
        packed = os.path.join(tmp, "packed")
        os.makedirs(art)
        make_artifact(args.ckpt_dir, art, args.kind, args.device)
        cc.convert_deepcompressor_checkpoint(args.ckpt_dir, art, packed, precision, gs)
        margs = cc.load_packed_config(packed)
        params = cc.load_packed_checkpoint(packed, margs, args.device)
        ppl_dc, n = evaluate(params, margs, tokens, args.seqlen, args.windows, kv_sim=True)
        print(f"DeepCompressor-imported {precision} g{gs} ppl {ppl_dc:.4f} ({n} windows)")

        # reference point: the port's RTN self-quantization of the same ckpt
        margs2, params2 = loader.load_model(
            args.ckpt_dir, QuantSpec.from_precision(precision, gs), device=args.device)
        ppl_rtn, _ = evaluate(params2, margs2, tokens, args.seqlen, args.windows, kv_sim=True)
        print(f"Self-quantized (RTN)    {precision} g{gs} ppl {ppl_rtn:.4f}")
        print(f"codes equal to RTN's: {codes_equal_share(params, params2):.6f}")
        rel = abs(ppl_dc - ppl_rtn) / ppl_rtn
        print(f"relative difference {rel:.4%}")
        assert rel < 0.02, "import path diverged from self-quantization"
        print("deepcompressor_roundtrip OK")
    return ppl_dc, ppl_rtn


if __name__ == "__main__":
    main()
