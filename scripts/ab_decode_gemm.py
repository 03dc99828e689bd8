#!/usr/bin/env python3
"""Times K4 (qserve_tpu_torch/kernels/csrc/paged_attention.cu) and the
three quantized GEMMs, K2, K8 and K9 (csrc/w4a8_gemm.cu,
w4a8_gemm_per_group.cu, w8a8_gemm.cu), as committed beside another
checkout's, on one NVIDIA GPU, or the engine steps they carry. From the
repo root:

    python3 scripts/ab_decode_gemm.py [--parent DIR] [--rounds N]
    python3 scripts/ab_decode_gemm.py --steps [--tree DIR]

Kernel mode: every library is built with the committed nvcc flags, all nvcc
processes at once, and so are the VARIANTS below (tunings of the change,
each checked like it); then one process times each (kernel, shape, tree)
with CUDA events around 20 back-to-back calls (device time: the host
enqueues ahead of the card), over rounds in alternating order, so the trees
compare within one run. Each of the change's calls is first held against
the parent's output (K2 bit for bit; K4 within its chip limit). K4 at
chip_smoke.py's decode shapes (Llama-3-8B B = 64, KV4 and KV8; Llama-2-7B
KV8; B = 1 and B = 8 over 4096-8192 keys; B = 1 and B = 8 over ~500
keys, also under the block table that max_model_len 8K or 32K would give,
as wide as the model runner no longer passes) with the wrapper's split
count and with 2x and 4x that, beside SDPA over the dequantized history
(chip_smoke.py's yardstick); K2 at Llama-3-8B's four linears at M = 64 and
2048, its gate_up and down at M = 8; K8 (g128) at Llama-3-8B's gate_up at
M = 64 and 2048 and its qkv at 2048; K9 at the gate_up at M = 8, 64 and
2048 and the W8 lm_head (f32 logits) at M = 64; and the routed K2, K8 and
K9 at Mixtral-8x7B's gate_up and down over a 6144-row stream of a real
top-2 routing. The GEMMs are held bit for bit (random bytes: both trees
wrap the same way). DIR is another checkout, e.g. a `git archive` of the
parent commit (its K4 entry point takes no split scratch: it is called
with that signature, PR 5's; the GEMMs' entry points are unchanged).

Steps mode: the engines of the tree at DIR (default: this one) at full
width and depth, random weights: Llama-3-8B serving chip_smoke.py's path a
traffic (8 prompts of 128-1024 tokens, 32 tokens out) at W4A8KV4
per-channel (path a), W4A8KV4 g128 with the W8 lm_head (path c's
precision) and W8A8KV8 (path e's), then Mixtral-8x7B prefilling two
2000-token prompts, one step each, at the same three precisions (paths g,
h, i; the first step of an engine carries its first-use costs: read the
second); each step's host clock and its device time (CUDA events around
the step's launches). Run it once per tree in one call to compare them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import sys
import tempfile
import time

from ab_common import CSRC, build, device_ms, smi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# source variants of the change, timed beside it (their outputs are checked
# too: each is a tuning of the same arithmetic)
VARIANTS = {
    "K4 4 stages": ("paged_attention", [("constexpr int STAGES = 3;",
                                         "constexpr int STAGES = 4;")]),
    # the level-2 reconstruction as four scalar multiply-adds a word (32 a
    # thread a step) instead of two 16-bit-lane ones
    "K8 scalar level2": ("w4a8_gemm_per_group", [(
        "  return __byte_perm(even * s2 + zz, odd * s2 + zz, 0x6240);",
        "  uint32_t r = 0;\n"
        "#pragma unroll\n"
        "  for (int b = 0; b < 4; ++b) {\n"
        "    const uint32_t q = ((b & 1 ? odd : even) >> (16 * (b >> 1))) & 0xFF;\n"
        "    r |= ((q * s2 + (zz & 0xFF)) & 0xFF) << (8 * b);\n"
        "  }\n"
        "  return r;")]),
}


def k4_cases(dev):
    """(tag, keep-alive, {label: change args}, parent args, out tensors): the
    change with the wrapper's split count, at 2x and 4x that, and, for the
    short histories, under a block table as wide as max_model_len 8K or 32K
    would make it (the split count the wrapper would take from that width)."""
    import numpy as np
    import torch

    import chip_smoke
    from qserve_tpu_torch.kernels import _build, kv_cache as kvc, paged_attention

    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(4)
    ctx_8b = rng.integers(512, 1537, 64)
    cases = []
    for tag, B, H, rep, ctx, bits, wide in (
            ("8B KV4 B=64 ctx~1024", 64, 8, 4, ctx_8b, 4, ()),
            ("8B KV8 B=64", 64, 8, 4, ctx_8b, 8, ()),
            ("Llama-2-7B KV8 rep 1 B=64", 64, 32, 1, ctx_8b, 8, ()),
            ("B=1 ctx 8192 KV4", 1, 8, 4, np.array([8192]), 4, ()),
            ("B=8 ctx 4096-8192 KV4", 8, 8, 4, rng.integers(4096, 8193, 8), 4, ()),
            ("B=1 ctx 8192 KV8", 1, 8, 4, np.array([8192]), 8, ()),
            ("B=8 ctx 4096-8192 KV8", 8, 8, 4, rng.integers(4096, 8193, 8), 8, ()),
            ("B=1 ctx 500 KV4", 1, 8, 4, np.array([500]), 4, (8192, 32768)),
            ("B=8 ctx 400-600 KV4", 8, 8, 4, rng.integers(400, 601, 8), 4, (8192, 32768))):
        D, ps = 128, 256
        cache, bt, cl, q, kc, vc = chip_smoke._paged_case(
            dev, g, B, H, rep, D, ps, ctx.tolist(), bits, centred=tag.startswith("B="))
        tables = {"change": bt}
        for keys in wide:  # the trimmed table's pages, then zeros
            w = torch.zeros(B, keys // ps, dtype=torch.int32, device=dev)
            w[:, :bt.shape[1]] = bt
            tables[f"table of {keys} keys"] = w
        ns = paged_attention.num_splits(B, H, bt.shape[1] * ps)
        splits = {"change": ns, "change 2x splits": 2 * ns, "change 4x splits": 4 * ns}
        splits.update({k: paged_attention.num_splits(B, H, t.shape[1] * ps)
                       for k, t in tables.items() if k != "change"})
        most = max(splits.values())
        pm = torch.empty(B, H * rep, most, device=dev)
        pl = torch.empty_like(pm)
        po = torch.empty(B, H * rep, most, D, device=dev)
        outs = (torch.empty_like(q), torch.empty_like(q))

        def head(t):
            return (q.data_ptr(), cache.data[0].data_ptr(), cache.scales[0].data_ptr(),
                    int(cache.scales.dtype == torch.bfloat16), t.data_ptr(), cl.data_ptr(),
                    kc.data_ptr(), vc.data_ptr())
        change = {}
        for label, n in splits.items():
            t = tables.get(label, bt)
            change[f"{label} ns={n}"] = (
                *head(t), outs[0].data_ptr(), pm.data_ptr(), pl.data_ptr(), po.data_ptr(),
                B, H * rep, H, D, bits, ps, t.shape[1], n, D**-0.5, 0, _build.stream())
        parent = (*head(bt), outs[1].data_ptr(), B, H * rep, H, D, bits, ps, bt.shape[1],
                  D**-0.5, 0, _build.stream())
        # yardstick: SDPA over the already dequantized history (chip_smoke.py's)
        k, v = kvc.gather_dequant_layer(cache.layer(0), bt, bits)
        k = torch.cat([k, kc.float()[:, None]], 1).to(torch.bfloat16).transpose(1, 2)
        v = torch.cat([v, vc.float()[:, None]], 1).to(torch.bfloat16).transpose(1, 2)
        pos = torch.arange(k.shape[2], device=dev)[None]
        h_len = (cl.long() - 1).clamp(min=0)[:, None]
        mask = ((pos < h_len) | (pos == k.shape[2] - 1))[:, None, None, :]
        qs = q[:, :, None, :]
        sdpa = (qs, k, v, mask)
        cases.append((tag, (cache, tables, cl, q, kc, vc, pm, pl, po, sdpa),
                      change, parent, outs))
    return cases


def k2_cases(dev):
    """(tag, keep-alive, (entry, args, out) of the change, the same of the
    parent)."""
    import torch

    import chip_smoke
    from qserve_tpu_torch.kernels import _build

    g = torch.Generator(device=dev).manual_seed(2)
    cfg = chip_smoke.LLAMA3_8B
    E, I = cfg["hidden_size"], cfg["intermediate_size"]
    kv = E // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    linears = dict(gate_up=(E, 2 * I), qkv=(E, E + 2 * kv), o=(E, E), down=(I, E))
    cases = []
    for M, names in ((64, linears), (2048, linears), (8, ["gate_up", "down"])):
        for name in names:
            K, N = linears[name]
            a = torch.randint(-128, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
            qw = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                               dtype=torch.int8)
            asc = torch.rand(M, 1, generator=g, device=dev) * 0.05
            asum = torch.randn(M, 1, generator=g, device=dev)
            s1 = torch.rand(N, generator=g, device=dev) * 1e-3
            sz = torch.rand(N, generator=g, device=dev) * 8e-3
            outs = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in range(2)]
            p = [t.data_ptr() for t in (a, qw, s1, sz, asc, asum)]
            args = [(*p, o.data_ptr(), M, N, K, _build.stream()) for o in outs]
            cases.append((f"{name} M={M} K={K} N={N}", (a, qw, asc, asum, s1, sz),
                          ("qs_w4a8_gemm_per_chn", args[0], outs[0]),
                          ("qs_w4a8_gemm_per_chn", args[1], outs[1])))
    st, dest, be, M, R, used = chip_smoke._routed_stream(dev, g)
    mix = chip_smoke.MIXTRAL_8X7B
    for name, K, N in (("routed gate_up", mix["hidden_size"], 2 * mix["intermediate_size"]),
                       ("routed down", mix["intermediate_size"], mix["hidden_size"])):
        a = torch.zeros(M, K, dtype=torch.int8, device=dev)
        a[dest] = torch.randint(-128, 128, (R, K), generator=g, device=dev,
                                dtype=torch.int8)
        live = torch.zeros(M, 1, device=dev)
        live[dest] = 1
        asc = torch.rand(M, 1, generator=g, device=dev) * 0.05 * live
        asum = torch.randn(M, 1, generator=g, device=dev) * live
        qw = torch.randint(-128, 128, (8, K // 2, N), generator=g, device=dev,
                           dtype=torch.int8)
        s1 = torch.rand(8, N, generator=g, device=dev) * 1e-3
        sz = torch.rand(8, N, generator=g, device=dev) * 8e-3
        outs = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in range(2)]
        p = [t.data_ptr() for t in (a, qw, s1, sz, asc, asum, be)]
        args = [(*p, o.data_ptr(), M, N, K, 256, _build.stream()) for o in outs]
        cases.append((f"{name} M={M} ({R} live) K={K} N={N}",
                      (a, qw, asc, asum, s1, sz, be),
                      ("qs_w4a8_gemm_per_chn_routed", args[0], outs[0]),
                      ("qs_w4a8_gemm_per_chn_routed", args[1], outs[1])))
    return cases


def _gemm_case(tag, keep, entry, head, out_shape, tail, dtype):
    """(tag, keep-alive, (entry, args, out) of the change, the same of the
    parent): the pointers `head`, then an output, then `tail`."""
    import torch

    from qserve_tpu_torch.kernels import _build

    outs = [torch.empty(out_shape, dtype=dtype, device=keep[0].device) for _ in range(2)]
    args = [(*(t.data_ptr() for t in head), o.data_ptr(), *tail, _build.stream())
            for o in outs]
    return (tag, keep, (entry, args[0], outs[0]), (entry, args[1], outs[1]))


def _stream_acts(dev, g, st, K):
    """The routed stream's int8 rows (pad rows 0) and per-row scales (pad
    rows 0), as chip_smoke.phase_gemm_routed lays them out."""
    import torch

    _, dest, _, M, R, _ = st
    a = torch.zeros(M, K, dtype=torch.int8, device=dev)
    a[dest] = torch.randint(-128, 128, (R, K), generator=g, device=dev, dtype=torch.int8)
    live = torch.zeros(M, 1, device=dev)
    live[dest] = 1
    return a, torch.rand(M, 1, generator=g, device=dev) * 0.05 * live


def k8_cases(dev):
    """K8 (csrc/w4a8_gemm_per_group.cu) at Llama-3-8B's gate_up (M = 64 and
    2048) and qkv (2048), g128, and routed at Mixtral-8x7B's gate_up and
    down; random bytes (both trees wrap the same way)."""
    import torch

    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(7)
    cfg, mix = chip_smoke.LLAMA3_8B, chip_smoke.MIXTRAL_8X7B
    E, I = cfg["hidden_size"], cfg["intermediate_size"]
    kv = E // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    cases, G = [], 128

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    for M, name, (K, N) in ((64, "gate_up", (E, 2 * I)), (2048, "gate_up", (E, 2 * I)),
                            (2048, "qkv", (E, E + 2 * kv))):
        a, qw, s2, z2 = i8(M, K), i8(K // 2, N), i8(K // G, N), i8(K // G, N)
        s1 = torch.rand(N, generator=g, device=dev) * 1e-3
        asc = torch.rand(M, 1, generator=g, device=dev) * 0.05
        head = (a, qw, s2, z2, s1, asc)
        cases.append(_gemm_case(f"{name} M={M} K={K} N={N} G={G}", head,
                                "qs_w4a8_gemm_per_group", head, (M, N), (0, M, N, K, G),
                                torch.bfloat16))
    st = chip_smoke._routed_stream(dev, g)
    be, M, R, ne = st[2], st[3], st[4], mix["num_local_experts"]
    for name, K, N in (("routed gate_up", E, 2 * mix["intermediate_size"]),
                       ("routed down", mix["intermediate_size"], E)):
        a, asc = _stream_acts(dev, g, st, K)
        qw, s2, z2 = i8(ne, K // 2, N), i8(ne, K // G, N), i8(ne, K // G, N)
        s1 = torch.rand(ne, N, generator=g, device=dev) * 1e-3
        head = (a, qw, s2, z2, s1, asc, be)
        cases.append(_gemm_case(f"{name} M={M} ({R} live) K={K} N={N} G={G}", head,
                                "qs_w4a8_gemm_per_group_routed", head, (M, N),
                                (M, N, K, G, 256), torch.bfloat16))
    return cases


def k9_cases(dev):
    """K9 (csrc/w8a8_gemm.cu) at Llama-3-8B's gate_up (M = 8, 64 and 2048)
    and the W8 lm_head (f32 logits, M = 64), and routed at Mixtral-8x7B's
    gate_up and down."""
    import torch

    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(9)
    cfg, mix = chip_smoke.LLAMA3_8B, chip_smoke.MIXTRAL_8X7B
    E, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    cases = []

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    for M, name, N, dtype in ((8, "gate_up", 2 * I, torch.bfloat16),
                              (64, "gate_up", 2 * I, torch.bfloat16),
                              (2048, "gate_up", 2 * I, torch.bfloat16),
                              (64, "lm_head f32", V, torch.float32)):
        a, qw = i8(M, E), i8(E, N)
        ws = torch.rand(N, generator=g, device=dev) * 1e-3
        asc = torch.rand(M, 1, generator=g, device=dev) * 0.05
        head = (a, qw, ws, asc)
        cases.append(_gemm_case(f"{name} M={M} K={E} N={N}", head, "qs_w8a8_gemm", head,
                                (M, N), (int(dtype == torch.float32), M, N, E), dtype))
    st = chip_smoke._routed_stream(dev, g)
    be, M, R, ne = st[2], st[3], st[4], mix["num_local_experts"]
    for name, K, N in (("routed gate_up", E, 2 * mix["intermediate_size"]),
                       ("routed down", mix["intermediate_size"], E)):
        a, asc = _stream_acts(dev, g, st, K)
        qw, ws = i8(ne, K, N), torch.rand(ne, N, generator=g, device=dev) * 1e-3
        head = (a, qw, ws, asc, be)
        cases.append(_gemm_case(f"{name} M={M} ({R} live) K={K} N={N}", head,
                                "qs_w8a8_gemm_routed", head, (M, N), (M, N, K, 256),
                                torch.bfloat16))
    return cases


# the GEMMs' sources and their cases
GEMMS = {"K2": "w4a8_gemm", "K8": "w4a8_gemm_per_group", "K9": "w8a8_gemm"}
CASES = {"K2": k2_cases, "K8": k8_cases, "K9": k9_cases}


def kernels(opts):
    import torch

    import chip_smoke
    from qserve_tpu_torch.kernels import _build, gemm, paged_attention

    P, I, F = _build.P, _build.I, _build.F
    k4_parent_args = [P] * 3 + [I] + [P] * 5 + [I] * 7 + [F, I, P]
    dev = "cuda"
    here = os.path.join(ROOT, CSRC)
    trees = [("change", here)] + ([("parent", os.path.join(opts.parent, CSRC))]
                                  if opts.parent else [])
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        started = [(tree, stem, build(tmp, f"{tree}-{stem}", csrc, stem))
                   for tree, csrc in trees
                   for stem in ("paged_attention",) + tuple(GEMMS.values())]
        started += [(name, stem, build(tmp, f"v{i}-{stem}", here, stem, edits))
                     for i, (name, (stem, edits)) in enumerate(VARIANTS.items())]
        for tree, stem, (so, proc) in started:  # all nvcc at once
            out = proc.communicate()[0]
            assert proc.returncode == 0, f"{tree} {stem}: nvcc failed\n{out}"
            libs[(tree, stem)] = ctypes.CDLL(so)

        def fn(tree, stem, name, argtypes):
            f = getattr(libs[(tree, stem)], name)
            f.argtypes, f.restype = argtypes, ctypes.c_int
            return f

        calls = {}  # (kernel, tag, variant) -> call
        wrote = {}  # (kernel, tag, variant) -> the output tensor it writes
        ref = {}  # (kernel, tag) -> the parent's output
        k4_variants = [v for v, (stem, _) in VARIANTS.items() if stem == "paged_attention"]
        want = opts.kernels.split(",")
        # the cases hold the tensors behind every pointer: keep them alive
        k4 = k4_cases(dev) if "K4" in want else []
        gemm_cases = {k: CASES[k](dev) for k in GEMMS if k in want}
        for tag, keep, change, parent, outs in k4:
            qs, k, v, mask = keep[-1]
            calls[("K4", tag, "SDPA (library)")] = (
                lambda qs=qs, k=k, v=v, mask=mask: torch.nn.functional
                .scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True)
                is None)
            labels = list(change)  # the first is the change as the wrapper runs it
            for tree in ["change"] + k4_variants:
                f = fn(tree, "paged_attention", "qs_paged_decode_attention",
                       paged_attention._ARGS)
                for label in (labels if tree == "change" else labels[:1]):
                    key = ("K4", tag, label if tree == "change" else f"{tree} {label}")
                    calls[key] = lambda f=f, a=change[label]: f(*a)
                    wrote[key] = outs[0]
            if opts.parent:
                fp = fn("parent", "paged_attention", "qs_paged_decode_attention",
                        k4_parent_args)
                calls[("K4", tag, "parent")] = lambda f=fp, a=parent: f(*a)
                ref[("K4", tag)] = outs[1]
        # the C entry points' argument lists: the same in the parent
        argtypes = {"qs_w4a8_gemm_per_chn": gemm._ARGS,
                    "qs_w4a8_gemm_per_chn_routed": gemm._ARGS_ROUTED,
                    "qs_w4a8_gemm_per_group": gemm._ARGS_GROUP,
                    "qs_w4a8_gemm_per_group_routed": gemm._ARGS_GROUP_ROUTED,
                    "qs_w8a8_gemm": gemm._ARGS_W8,
                    "qs_w8a8_gemm_routed": gemm._ARGS_W8_ROUTED}
        for kernel, cases in gemm_cases.items():
            stem = GEMMS[kernel]
            variants = [v for v, (st, _) in VARIANTS.items() if st == stem]
            for tag, _, (name, args, out), (pname, pargs, pout) in cases:
                for tree in ["change"] + variants:
                    f = fn(tree, stem, name, argtypes[name])
                    calls[(kernel, tag, tree)] = lambda f=f, a=args: f(*a)
                    wrote[(kernel, tag, tree)] = out
                if opts.parent:
                    f = fn("parent", stem, pname, argtypes[pname])
                    calls[(kernel, tag, "parent")] = lambda f=f, a=pargs: f(*a)
                    ref[(kernel, tag)] = pout
        # the parent's outputs first, then each of the change's against them;
        # a call that fails its check is reported and not timed
        failed = []
        for key in sorted(calls, key=lambda k: k[2] != "parent"):
            assert calls[key]() == 0, key
            torch.cuda.synchronize()
            want = ref.get(key[:2])
            if key[2] == "parent" or want is None or key not in wrote:
                continue
            try:
                if key[0] in GEMMS:
                    assert torch.equal(wrote[key], want), "differs from the parent"
                else:
                    chip_smoke.hold(f"{key}: vs the parent", wrote[key], want, 1e-3)
            except AssertionError as e:
                print(f"FAILED {key}: {e}", flush=True)
                failed.append(key)
                del calls[key]
        times = {key: [] for key in calls}
        keys = list(calls)
        for r in range(opts.rounds):  # parent, change, change, parent, ...
            for key in (keys if r % 2 else keys[::-1]):
                times[key].append(device_ms(calls[key]))
    print(smi())
    if failed:
        print(f"{len(failed)} calls failed their check: {failed}")
    for (kernel, tag, variant), t in times.items():
        print(f"{kernel} {tag:30s} {variant:34s} {statistics.median(t):.4g} ms "
              f"(median of {len(t)} rounds; min {min(t):.4g}, max {max(t):.4g})",
              flush=True)
    return 1 if failed else 0


def run_steps(tag, cfg, prompts, max_tokens, **precision):
    """Serves `prompts` (token counts, random ids) on a fresh engine of the
    imported tree at full width and depth, random weights; prints each step
    kind's host ms (the first four, and the median) and CUDA-event device
    ms median."""
    import gc

    import numpy as np
    import torch

    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams

    t0 = time.perf_counter()
    engine = EngineArgs(hf_config=cfg, random_weights=True, seed=0, device="cuda",
                        block_size=256, max_num_batched_tokens=2048,
                        max_num_seqs=64, **precision).build_engine()
    print(f"  {tag}: engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    for i, n in enumerate(prompts):
        engine.add_request(
            f"{tag}{i}", prompt_token_ids=rng.integers(0, cfg["vocab_size"], int(n)).tolist(),
            sampling_params=SamplingParams(max_tokens=max_tokens, ignore_eos=True))
    host, dev = {}, {}
    while engine.has_unfinished_requests():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        engine.step()
        e1.record()
        torch.cuda.synchronize()
        kind = engine.last_step_kind
        host.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        dev.setdefault(kind, []).append(e0.elapsed_time(e1))
    for kind in host:
        print(f"  {tag} {kind}: {len(host[kind])} steps, host ms "
              f"{[round(x, 2) for x in host[kind][:4]]} (median "
              f"{statistics.median(host[kind]):.4g}), device ms median "
              f"{statistics.median(dev[kind]):.4g}", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def steps(opts):
    tree = os.path.abspath(opts.tree or ROOT)
    sys.path.insert(0, tree)
    import numpy as np

    import chip_smoke  # this script's tree: only its model configs are read

    print(f"steps of {tree} on {smi()}", flush=True)
    lens = np.random.default_rng(0).integers(128, 1025, 8)  # chip_smoke path a
    precisions = (("w4a8kv4", dict(precision="w4a8kv4", group_size=-1)),
                  ("w4a8kv4 g128", dict(precision="w4a8kv4", group_size=128)),
                  ("w8a8kv8", dict(precision="w8a8kv8", group_size=-1)))
    for tag, kw in precisions:  # paths a, c (with its W8 lm_head), e
        run_steps(f"llama3-8b {tag}", chip_smoke.LLAMA3_8B, lens, 32,
                  quant_lm_head=tag.endswith("g128"), **kw)
    for tag, kw in precisions:  # paths g, h, i
        run_steps(f"mixtral-8x7b {tag}", chip_smoke.MIXTRAL_8X7B, [2000, 2000], 4, **kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose kernels to time beside these")
    ap.add_argument("--kernels", default="K2,K4,K8,K9",
                    help="kernel mode: which of K2, K4, K8, K9 to time")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", action="store_true", help="time engine steps instead")
    ap.add_argument("--tree", help="steps mode: the checkout whose engine to run")
    opts = ap.parse_args()
    if opts.steps:
        steps(opts)
        return 0
    sys.path.insert(0, ROOT)
    return kernels(opts)


if __name__ == "__main__":
    sys.exit(main())
