#!/usr/bin/env python3
"""Times source variants of the two prefill attention kernels, K3
(qserve_tpu_torch/kernels/csrc/flash_attention.cu) and K6
(csrc/prefix_attention.cu), on one NVIDIA GPU. Every variant is built with
the committed library's nvcc flags, all nvcc processes at once; then one
process times them all with CUDA events (median of 20 calls), interleaved
over rounds, so variants compare within one run. From the repo root:

    python3 scripts/ab_prefill_attention.py [--parent DIR] [--rounds N]

Variants: K3 and K6 as committed; with --parent, K3 and K6 from DIR's
qserve_tpu_torch/kernels/csrc (another checkout, e.g. a `git archive` of
the parent commit), each with its own headers; and K6 with one stage cut
out: no_convert (the packed codes are staged but not turned into bf16
tiles), no_prefix_copy (no cp.async of the packed codes), no_prefix_math
(prefix tiles staged and converted, no QK^T/softmax/PV on them), no_chunk
(phase 2 skipped), page_division (every page lookup divides by the page
size; the kernel shifts when it is a power of two), four_warps (64 folded
rows a block, not 128), three_stages (two tiles in flight while one
computes, not one). A cut variant's output is wrong by design; only its
time is read. Shapes: K3 at Llama-3-8B's four packed prompts (T = 2048,
32 heads, 8 kv heads) and with Llama-2-7B's 32 kv heads; K6 at Llama-3-8B's
chunk of 2048 rows (1900 live) over a 4096 prefix, KV4 and KV8, and
Llama-2-7B's over a 2048 prefix, KV8.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ab_common import CSRC, build, smi  # noqa: E402

CUTS = {
    "no_convert": [("if (it < n1) {\n      // packed codes -> bf16 codes",
                    "if (it < n1) {\n      if (false)  // packed codes -> bf16 codes")],
    "no_prefix_copy": [("cp_async16(packed + ((b * 2 + kv) * BK + j) * DC + ch * 16, src[u] ? src[u] : data,",
                        "if (false) cp_async16(packed + ((b * 2 + kv) * BK + j) * DC + ch * 16, src[u] ? src[u] : data,")],
    "no_prefix_math": [("      attend_tile<D>(\n          qa, Ks, Vs,\n          [&](float acc, int i, int j) {\n            return full ||",
                        "      if (false) attend_tile<D>(\n          qa, Ks, Vs,\n          [&](float acc, int i, int j) {\n            return full ||")],
    "no_chunk": [("const int n2 = qmax >= 0 ?", "const int n2 = false ?")],
    "page_division": [("return pow2 ? s >> sh : s / ps;", "return s / ps;"),
                      ("return pow2 ? s & (ps - 1) : s % ps;", "return s % ps;")],
    "four_warps": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "three_stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}


def k3_cases(dev):
    """(shape, args after the library) for qs_flash_prefill_attention; the
    tensors stay referenced by the returned list."""
    import torch

    from qserve_tpu_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for tag, Hkv in (("8B T=2048 4 prompts", 8), ("Llama-2-7B Hkv=32", 32)):
        T, Hq, D = 2048, 32, 128
        seg = torch.from_numpy(chip_smoke._segments(T, [700, 512, 436, 300])).to(dev)
        q, k, v = (torch.randn(T, h, D, generator=g, device=dev).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        out = torch.empty_like(q)
        keep = (q, k, v, seg, out)
        cases.append((tag, keep, (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                                  out.data_ptr(), T, Hq, Hkv, D, D**-0.5, 0, _build.stream())))
    return cases


def k6_cases(dev):
    import torch

    from qserve_tpu_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(6)
    cases = []
    for tag, H, rep, S, bits in (("8B KV4 prefix 4096", 8, 4, 4096, 4),
                                 ("8B KV8 prefix 4096", 8, 4, 4096, 8),
                                 ("Llama-2-7B KV8 prefix 2048", 32, 1, 2048, 8)):
        cache, bt, q, k, v, seg, pos = chip_smoke._prefix_case(
            dev, g, H, rep, 128, 256, S, 2048, 1900, 32, bits)
        out = torch.empty_like(q)
        keep = (cache, bt, q, k, v, seg, pos, out)
        cases.append((tag, keep, (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), pos.data_ptr(),
            cache.data[0].data_ptr(), cache.scales[0].data_ptr(),
            int(cache.scales.dtype == torch.bfloat16), bt[0].data_ptr(), out.data_ptr(),
            2048, H * rep, H, 128, bits, 256, S, 128**-0.5, 0, _build.stream())))
    return cases


def main():
    from qserve_tpu_torch.kernels import flash_attention, prefix_attention

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose K3 and K6 to time beside these")
    ap.add_argument("--rounds", type=int, default=5)
    opts = ap.parse_args()
    here = os.path.join(ROOT, CSRC)
    variants = [("K3", here, "flash_attention", ()), ("K6", here, "prefix_attention", ())]
    if opts.parent:
        there = os.path.join(opts.parent, CSRC)
        variants += [("K3 parent", there, "flash_attention", ()),
                     ("K6 parent", there, "prefix_attention", ())]
    variants += [(f"K6 {name}", here, "prefix_attention", cuts) for name, cuts in CUTS.items()]
    dev = "cuda"
    cases = {"flash_attention": k3_cases(dev), "prefix_attention": k6_cases(dev)}
    entry = {"flash_attention": ("qs_flash_prefill_attention", flash_attention._ARGS),
             "prefix_attention": ("qs_prefix_prefill_attention", prefix_attention._ARGS)}
    with tempfile.TemporaryDirectory() as tmp:
        started = [(name, stem, build(tmp, str(i), csrc, stem, cuts))
                   for i, (name, csrc, stem, cuts) in enumerate(variants)]
        calls = {}
        for name, stem, (so, proc) in started:  # all nvcc at once
            log = proc.communicate()[0]
            assert proc.returncode == 0, f"{name}: nvcc failed\n{log}"
            fn = getattr(ctypes.CDLL(so), entry[stem][0])
            fn.argtypes, fn.restype = entry[stem][1], ctypes.c_int
            for tag, _, args in cases[stem]:
                calls[(name, tag)] = lambda fn=fn, args=args: fn(*args)
        for call in calls.values():
            assert call() == 0
        times = {key: [] for key in calls}
        for _ in range(opts.rounds):
            for key, call in calls.items():
                times[key].append(chip_smoke.cuda_ms(call, warmup=2))
    print(smi())
    for (name, tag), t in times.items():
        print(f"{name:17s} {tag:27s} {statistics.median(t):.4g} ms (median of {len(t)} "
              f"rounds; min {min(t):.4g}, max {max(t):.4g})", flush=True)


if __name__ == "__main__":
    main()
