#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qserve_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

1. Builds every CUDA kernel from qserve_tpu_torch/kernels/csrc (one nvcc
   per source, all at once) and prints what ptxas reported for each (paged
   decode must not spill at any instance).
2. Kernel phases: each of the twelve kernels at the main paths' shapes
   (Llama-3-8B: decode B = 64, prefill and chunk T = 2048, context ~1024 and
   a 4096-token prefix over 256-token pages, sampling at [B, 128256] for
   B = 64, 1, 8 and 16 (the engine's row counts), the fused norm/quant pass
   at T = 2048, 64 and 1;
   Llama-2-7B: its qkv, gate_up and ragged K = 11008 down projections,
   SwiGLU at I = 11008, prefill, decode and chunk attention and the cache
   append without GQA (32 kv heads), sampling at [B, 32000]; the fused
   norm/quant pass also at a width 2 short of a multiple of 8 and one of
   70000 columns (a row in chunks); both cache
   modes, KV4 and KV8; plus small-H, D = 64, f32-scale and sliding-window
   cases; the three routed MoE GEMMs at Mixtral-8x7B's gate_up and down
   over a stream of M = 6144 rows in 24 blocks of 256, laid out by a real
   top-2 routing of 2048 tokens over 8 experts, and the per-group one at
   the ragged K = 11008; the prefill attention kernels also at a rep of 3
   and, K6, a 512-row last chunk over a 4096 prefix; paged decode also at
   B = 1 and 8 over 4096-8192 keys; the three attention kernels at head
   dims 96 and 256; the W4A8 GEMMs at Qwen2-0.5B's widths, whose hidden 896
   puts a g128 group across the nibble planes; K2, K8 and K9, which share
   one wgmma main loop on 128x128 tiles, also at a ragged N (a 64-column
   tail tile) and M = 8) against its plain
   PyTorch version on the same inputs, with the tolerance stated in the
   phase (the attention kernels per element, shown to fail without one
   64-key tile); times the kernel, the plain version and, where one exists,
   one PyTorch library call computing the same function (CUDA events,
   median of 20: one call's span, the host's launch in it); the fused
   norm/quant pass and the sampler also by device time (20 back-to-back
   calls captured in a CUDA graph and replayed); the fused KV quantize-and-
   append (K5) bit for bit in 11 cases (KV4 and KV8, with and without a
   zero point, bf16 and f32 scales, D = 64, 96, 128 and 256, the mixed
   step's strided view, an unaligned view on its scalar path), timed also
   by device time and beside the plain quantize alone, with the peak
   memory of it and of its plain chain at the 8B prefill. The build report
   counts the tensor-core instructions in the SASS of K3, K6 and the three
   GEMM libraries (K2, K8, K9) and fails on none; the GEMMs must show
   wgmma's (IGMMA) and no mma.sync (IMMA).
3. Reference phase: a small model served by the kernels on the card and by
   the plain versions on the CPU (prefill, decode, one chunk step, one mixed
   chunk+decode step) at W4A8KV4 per-channel, W4A8KV4 g128, W4A8KV8 g128
   with the W8 lm_head, W8A8KV8 with the W8 lm_head and W16A16KV8, and a
   small Mixtral (4 experts, top-2, routed in 128-row blocks from 16 rows
   up) at W4A8KV4 per-channel, W4A8KV4 g128, W8A8KV8 and W16A16KV8; logits
   must agree at every step, and so must the Mixtral's router probabilities
   (within 5e-3), the CPU giving a token whose experts differ the card's.
4. Engine phase: EngineArgs -> LLMEngine at full width and depth (32
   layers, random weights from a seed, default scheduler: chunked prefill
   and mixed steps on), each engine built and freed in turn, the launch
   counts set to 0 before each path and read after it, each step timed on
   the host clock and by CUDA events around its launches, with its peak
   allocated memory:
   a. Llama-3-8B W4A8KV4 per-channel, whole-prompt prefill + paged decode:
      8 requests of 128-1024 prompt tokens and 32 output tokens (6 greedy, 2
      at temperature 0.8);
   checkpoint phase, after path a (checkpoint files go to a gitignored
      directory in the checkout, once the disk is shown to have room, and
      are removed after):
      - path a's params saved as a packed QoQ checkpoint (~5.6 GB) and
        served again through EngineArgs(model=<dir>, quant_path=<dir>):
        every leaf bit for bit, path a's greedy streams token for token,
        path a's kernels launched; save and load GB/s;
      - the same checkpoint rebuilt with benchmarking=True (device-fed
        decode): the chain of sampled ids kept on the card equals path a's
        greedy streams, and no decode step waits for the card
        (torch.cuda.set_sync_debug_mode); the decode step's host ms,
        CUDA-event span and busy share (torch.profiler) with the feed and
        without, interleaved in one engine;
      - a float HF directory at Llama-3-8B widths cut to 2 layers (bf16,
        two safetensors shards, ~3 GB) quantized at load on the card: equal
        bit for bit to quantize_params on the CPU, then 4 requests served;
   b. the same engine, chunked prefill: 7 short requests are decoding when a
      ~6000-token prompt arrives and admits in three chunks that ride with
      the decode batch; two more requests share a page-aligned prefix with
      an earlier one through prefix_pos (one rides with the decode batch,
      one runs alone); half of the requests sample with temperature 0.8,
      top_p 0.9, top_k 50;
   c. Llama-3-8B W4A8KV4 g128 with the W8 lm_head: 6 requests decode, a
      3000-token prompt admits beside them in two mixed steps, a 2500-token
      prompt then runs alone (a prefill and a chunk step);
   d. Llama-2-7B W4A8KV8 g128 (43 groups a nibble plane at K = 11008, 32 kv
      heads: attention without GQA over KV8 pages), the same traffic;
   e. Llama-3-8B W8A8KV8, the same traffic;
   f. Llama-3-8B W16A16KV8, the same traffic: the attention, append and
      sampling kernels over bf16 library products, no quantizing kernel;
   g. Mixtral-8x7B W4A8KV4 per-channel, the same traffic: steps of 1024
      rows or more take the routed GEMMs (2 a layer), shorter ones the
      masked loop over all 8 experts (18 dense GEMMs a layer);
   h. Mixtral-8x7B W4A8KV4 g128, the same;
   i. Mixtral-8x7B W8A8KV8, the same.
   Every kernel a path's precision calls must have launched on it, and the
   GEMMs of the other precisions must not.
5. Refusal phase: what is still unported (tensor parallelism) raises
   instead of running something else.

Prints the card's name and power limit, one JSON line of per-kernel results
and, last, {"ok": true, "device": {...}}. Exits non-zero, without those
lines, when there is no CUDA device, when the port cannot be imported, or
when any phase fails. The port's text path (tokenizer, chat templates)
is held against the JAX package on the CPU (tests/test_torch_checkpoint.py);
here it runs once, through e2e_generation, where transformers and
tokenizers are installed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Llama-3-8B (meta-llama/Meta-Llama-3-8B config.json)
LLAMA3_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rope_theta=500000.0, rms_norm_eps=1e-5,
)
# Llama-2-7B (meta-llama/Llama-2-7b-hf config.json)
LLAMA2_7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
    rope_theta=10000.0, rms_norm_eps=1e-5,
)
# Qwen2-0.5B (Qwen/Qwen2-0.5B config.json): its widths for the GEMMs
QWEN2_05B = dict(
    vocab_size=151936, hidden_size=896, intermediate_size=4864,
    num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
)
# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json)
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rope_theta=1e6, rms_norm_eps=1e-5, sliding_window=None,
    num_local_experts=8, num_experts_per_tok=2,
)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32, bf16 and int8 ops/s
HBM_BPS = 3.35e12
F32_OPS = 67e12  # outside the tensor cores
BF16_OPS = 989e12
INT8_OPS = 1979e12

ROUTES = {
    "elementwise": ("cuda", "qserve_tpu_torch/kernels/csrc/elementwise.cu",
                    "qserve_tpu/kernels/pallas_elementwise.py:159"),
    "w4a8_gemm_per_chn": ("cuda", "qserve_tpu_torch/kernels/csrc/w4a8_gemm.cu",
                          "qserve_tpu/kernels/pallas_gemm.py:200"),
    "w4a8_gemm_per_group": ("cuda", "qserve_tpu_torch/kernels/csrc/w4a8_gemm_per_group.cu",
                            "qserve_tpu/kernels/pallas_gemm.py:448"),
    "w8a8_gemm": ("cuda", "qserve_tpu_torch/kernels/csrc/w8a8_gemm.cu",
                  "qserve_tpu/kernels/pallas_gemm.py:680"),
    "flash_prefill_attention": ("cuda", "qserve_tpu_torch/kernels/csrc/flash_attention.cu",
                                "qserve_tpu/kernels/pallas_flash_attention.py:124"),
    "paged_decode_attention": ("cuda", "qserve_tpu_torch/kernels/csrc/paged_attention.cu",
                               "qserve_tpu/kernels/pallas_paged_attention.py:360"),
    "kv_append": ("cuda", "qserve_tpu_torch/kernels/csrc/kv_append.cu",
                  "qserve_tpu/kernels/pallas_kv_append.py:261"),
    "prefix_prefill_attention": (
        "cuda", "qserve_tpu_torch/kernels/csrc/prefix_attention.cu",
        "qserve_tpu/kernels/pallas_prefix_attention.py:268"),
    "sample_filtered": ("cuda", "qserve_tpu_torch/kernels/csrc/sampler.cu",
                        "qserve_tpu/kernels/pallas_sampler.py:172"),
    "w4a8_gemm_per_chn_routed": ("cuda", "qserve_tpu_torch/kernels/csrc/w4a8_gemm.cu",
                                 "qserve_tpu/kernels/pallas_gemm.py:742"),
    # one kernel for the tiled (:854) and the ragged (:925) group counts
    "w4a8_gemm_per_group_routed": (
        "cuda", "qserve_tpu_torch/kernels/csrc/w4a8_gemm_per_group.cu",
        "qserve_tpu/kernels/pallas_gemm.py:854"),
    "w8a8_gemm_routed": ("cuda", "qserve_tpu_torch/kernels/csrc/w8a8_gemm.cu",
                         "qserve_tpu/kernels/pallas_gemm.py:805"),
}
DENSE_GEMMS = ("w4a8_gemm_per_chn", "w4a8_gemm_per_group", "w8a8_gemm")
ROUTED_GEMMS = ("w4a8_gemm_per_chn_routed", "w4a8_gemm_per_group_routed",
                "w8a8_gemm_routed")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of one call (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def device_ms(fn, n=20, replays=5):
    """Device time of one call: n back-to-back calls captured in one CUDA
    graph and replayed, timed by CUDA events, so the host's launch time
    drops out even where it exceeds the kernel's (cuda_ms's one-call span
    includes it)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (n * replays)


def bound(nbytes, ops, peak):
    """Least time (ms) for the work: bytes over HBM rate vs ops over peak."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Results:
    def __init__(self):
        self.rows = {}  # kernel -> its headline row
        self.all = []  # every (kernel, shape) row of the run

    def add(self, name, shape, err, ms, plain_ms, nbytes, ops, peak, library_ms,
            **extra):
        b, by = bound(nbytes, ops, peak)
        lib = "null" if library_ms is None else f"{library_ms:.4g}"
        labels = {"dev_ms": "device ms (20 back-to-back calls in a CUDA graph)",
                  "quantize_ms": "plain quantize alone ms"}
        more = "".join(f"  {labels.get(k, k)} {v:.4g}" for k, v in extra.items())
        log(f"  {name} [{shape}]: max_abs_err {err:.3g}  kernel {ms:.4g} ms (one call)  "
            f"plain {plain_ms:.4g} ms  library {lib} ms  bound {b:.3g} ms ({by}){more}")
        row = dict(shape=shape, max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                   bound_ms=b, bound_by=by, library_ms=library_ms, **extra)
        self.rows.setdefault(name, row)  # the first shape is the headline one
        self.all.append(dict(row, name=name))
        return row


def library_or_none(fn):
    try:
        return cuda_ms(fn)
    except (RuntimeError, NotImplementedError) as e:  # refused these inputs
        log(f"    library call unavailable: {e}")
        return None


def hold(tag, got, want, floor):
    """Each element of got within one bf16 step of the plain value (2^-7
    |want|) plus floor x the largest |want|: both sides sum in f32 in other
    orders and round once to bf16, so an element may land on the neighbouring
    bf16 value. An output here is a mean of ~N(0, 1) values over hundreds or
    thousands of keys (~0.02-0.05), so a flat atol would pass a lost key.
    Logs the worst element against its limit and the floor that would just
    pass; returns the max abs error."""
    import torch

    assert torch.isfinite(got.float()).all()
    wf = want.float()
    peak = wf.abs().max()
    limit = 2.0**-7 * wf.abs() + floor * peak
    diff = (got.float() - wf).abs()
    err = diff.max().item()
    need = ((diff - 2.0**-7 * wf.abs()) / peak).max().item()
    log(f"  {tag}: max_abs_err {err:.3g} at {(diff / limit).max().item():.3g} of its "
        f"limit (one bf16 step + {floor:g} x max |out| = {peak.item():.3g}; mean |out| "
        f"{wf.abs().mean().item():.3g}; the floor that would just pass: {need:.3g})")
    assert bool((diff <= limit).all()), f"{tag}: err {err}"
    return err


def has_teeth(tag, broken, want, floor):
    """The plain output with one 64-key tile missing must fail hold's limit
    on some element."""
    wf = want.float()
    limit = 2.0**-7 * wf.abs() + floor * wf.abs().max()
    over = ((broken.float() - wf).abs() / limit).max().item()
    log(f"    {tag}: the plain output without one 64-key tile reaches {over:.3g}x "
        f"the limit")
    assert over > 1, f"{tag}: the limit passes a missing 64-key tile"


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------


def phase_elementwise(res, dev):
    """K1's four modes against their plain versions: h + delta equal, quant
    codes exact, the norm and SiLU modes' codes within 1 and at most 1e-3 of
    them differing (the sum of squares and the IEEE exp are taken in other
    orders), scales within 1e-6. Timed at T = 2048 and 64 (Llama-3-8B's E
    and I, Llama-2-7B's I) by one-call events (the host's launch included)
    and over back-to-back calls (device time); held also at T = 1, at a
    width 2 short of a multiple of 8 (the kernel's scalar tail) and at a
    width past 65536 columns (a row in two chunks, three in mode 3)."""
    import torch

    from qserve_tpu_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(1)
    E = LLAMA3_8B["hidden_size"]  # Llama-2-7B's too
    widths = (LLAMA3_8B["intermediate_size"], LLAMA2_7B["intermediate_size"])

    def check_codes(got, want, exact):
        d = (got[0].int() - want[0].int()).abs()
        frac = (d > 0).float().mean().item()
        assert d.max().item() <= (0 if exact else 1), f"codes off by {d.max().item()}"
        assert frac <= 1e-3, f"{frac:.2e} of codes differ"
        rel = ((got[1] - want[1]).abs() / want[1]).max().item()
        assert rel <= 1e-6, f"scale rel err {rel}"
        return d.max().item()

    def case(name, shape, err, fn, plain, nbytes, timed):
        if not timed:
            log(f"  elementwise [{name} {shape}]: max code err {err}")
            return
        res.add("elementwise", f"{name} {shape}", err, cuda_ms(fn), cuda_ms(plain),
                nbytes, 0, BF16_OPS, None, dev_ms=device_ms(fn))

    for T, E, widths, timed in ((2048, E, widths, True), (64, E, widths, True),
                                (1, E, widths, False), (64, E - 2, (E - 2,), False),
                                (8, 70000, (70000,), False)):
        h = torch.randn(T, E, generator=g, device=dev).to(torch.bfloat16)
        d = torch.randn(T, E, generator=g, device=dev).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(E, generator=g, device=dev)
        got = ops.add_rmsnorm_quant(h, d, w, 1e-5, True)
        want = ops.add_rmsnorm_quant_plain(h, d, w, 1e-5, True)
        assert torch.equal(got[0], want[0]), "h + delta differs"
        err = check_codes(got[1:], want[1:], exact=False)
        case("add_rmsnorm_quant", f"T={T} E={E}", err,
             lambda: ops.add_rmsnorm_quant(h, d, w, 1e-5, True),
             lambda: ops.add_rmsnorm_quant_plain(h, d, w, 1e-5, True),
             3 * T * E * 2 + E * 4 + T * E + 8 * T, timed)

        x = torch.randn(T, E, generator=g, device=dev).to(torch.bfloat16)
        err = check_codes(ops.quant_per_token(x, True),
                          ops.quant_per_token_plain(x, True), exact=True)
        case("quant", f"T={T} K={E}", err, lambda: ops.quant_per_token(x, True),
             lambda: ops.quant_per_token_plain(x, True), T * E * 2 + T * E + 8 * T, timed)

        # rmsnorm_quant: the same kernel body, off the main paths
        err = check_codes(ops.rmsnorm_quant(x, w, 1e-5, True),
                          ops.rmsnorm_quant_plain(x, w, 1e-5, True), exact=False)
        case("rmsnorm_quant", f"T={T} E={E}", err,
             lambda: ops.rmsnorm_quant(x, w, 1e-5, True),
             lambda: ops.rmsnorm_quant_plain(x, w, 1e-5, True),
             T * E * 2 + E * 4 + T * E + 8 * T, timed)

        for I in widths:
            gu = (2 * torch.randn(T, 2 * I, generator=g, device=dev)).to(torch.bfloat16)
            err = check_codes(ops.silu_mul_quant(gu, True),
                              ops.silu_mul_quant_plain(gu, True), exact=False)
            case("silu_mul_quant", f"T={T} I={I}", err,
                 lambda: ops.silu_mul_quant(gu, True),
                 lambda: ops.silu_mul_quant_plain(gu, True),
                 T * 2 * I * 2 + T * I + 8 * T, timed)


def phase_gemm(res, dev):
    """K2, K8 and K9 against their plain versions, bit for bit: integer
    products, then the same f32 epilogue in the same order. All three run
    gemm_common.cuh's wgmma loop (128x128 tiles); they differ in the B stage
    (K2 unpacks nibbles, K8 also rebuilds q * s2 + z2, K9 transposes int8)
    and the epilogue."""
    import torch

    from qserve_tpu_torch.kernels import ops
    from qserve_tpu_torch.layers import linear as lin
    from qserve_tpu_torch.quant import packing, qoq

    g = torch.Generator(device=dev).manual_seed(2)
    def linears(cfg):
        E, I = cfg["hidden_size"], cfg["intermediate_size"]
        kv = E // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
        return dict(gate_up=(E, 2 * I), qkv=(E, E + 2 * kv), o=(E, E), down=(I, E))

    E = LLAMA3_8B["hidden_size"]
    shapes = linears(LLAMA3_8B)

    def acts(M, K):
        a = torch.randint(-128, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
        return a, torch.rand(M, 1, generator=g, device=dev) * 0.05

    def weight(K, N):
        return torch.randn(K, N, generator=g, device=dev) * 0.02

    def check(name, tag, got, want):
        err = (got.float() - want.float()).abs().max().item()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"{name} {tag}: max err {err}"
        return err

    # K2 at Llama-3-8B's four linears, Qwen2-0.5B's (hidden 896: K/2 = 448
    # is no multiple of 128) and a ragged N (N % 128 != 0)
    k2_shapes = dict(shapes, **{f"qwen2_0.5b_{n}": s for n, s in linears(QWEN2_05B).items()},
                     ragged_n=(4096, 1088))
    for M in (64, 2048):
        for name, (K, N) in k2_shapes.items():
            qw = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                               dtype=torch.int8)
            s1 = torch.rand(N, generator=g, device=dev) * 1e-3
            sz = torch.rand(N, generator=g, device=dev) * 8e-3
            a, asc = acts(M, K)
            asum = torch.randn(M, 1, generator=g, device=dev)
            args = (a, asc, asum, qw, s1, sz)
            err = check("w4a8_gemm_per_chn", f"{name} M={M}",
                        ops.w4a8_gemm_per_chn(*args), ops.w4a8_gemm_per_chn_plain(*args))
            wu = packing.unpack_w4(qw)
            nbytes = M * K + K // 2 * N + 8 * N + 8 * M + 2 * M * N
            res.add("w4a8_gemm_per_chn", f"{name} M={M} K={K} N={N}", err,
                    cuda_ms(lambda: ops.w4a8_gemm_per_chn(*args)),
                    cuda_ms(lambda: ops.w4a8_gemm_per_chn_plain(*args)),
                    nbytes, 2 * M * K * N, INT8_OPS,
                    library_or_none(lambda: torch._int_mm(a, wu)))

    # K8. Its weights come from the quantizer, not from random bytes as
    # K2's above: q * s2 + z2 must fit an int8, which only the quantizer's
    # (s2, z2) guarantee. Off that lattice the TPU kernel (no wrap) and its
    # reference (wraps to int8) part; the port wraps like the reference.
    # Llama-2-7B's o is the 8B's; its down is the ragged one: 43 groups a
    # nibble plane.
    # Qwen2-0.5B at g128: K = 896 puts group 3 across the nibble planes
    # (K/2 = 448 = 3.5 groups); a ragged N's last tile is 64 columns wide
    G = 128
    group_shapes = dict(shapes, **{f"llama2_7b_{n}": s
                                   for n, s in linears(LLAMA2_7B).items() if n != "o"},
                        **{f"qwen2_0.5b_{n}": s for n, s in linears(QWEN2_05B).items()},
                        ragged_n=(4096, 1088))
    for name, (K, N) in group_shapes.items():
        p = lin.quantize_linear_from_float(weight(K, N), 4, G)
        w8 = qoq.pergroup_level2_int8(
            qoq.PerGroupW4(packing.unpack_w4(p.qweight), *p[1:]), G)
        for M in (64, 2048) + ((8,) if name in ("gate_up", "ragged_n") else ()):
            a, asc = acts(M, K)
            args = (a, asc, *p, G)
            err = check("w4a8_gemm_per_group", f"{name} M={M}",
                        ops.w4a8_gemm_per_group(*args),
                        ops.w4a8_gemm_per_group_plain(*args))
            nbytes = (M * K + K // 2 * N + 2 * (K // G) * N + 4 * N + 4 * M
                      + 2 * M * N)
            res.add("w4a8_gemm_per_group", f"{name} M={M} K={K} N={N} G={G}", err,
                    cuda_ms(lambda: ops.w4a8_gemm_per_group(*args)),
                    cuda_ms(lambda: ops.w4a8_gemm_per_group_plain(*args)),
                    nbytes, 2 * M * K * N, INT8_OPS,
                    library_or_none(lambda: torch._int_mm(a, w8)))
        if name == "qkv":  # the f32 output: no path asks K8 for it, held here
            args = (a, asc, *p, G, torch.float32)
            check("w4a8_gemm_per_group", "qkv M=2048 f32 out",
                  ops.w4a8_gemm_per_group(*args), ops.w4a8_gemm_per_group_plain(*args))
            log("  w4a8_gemm_per_group [qkv M=2048, f32 out]: equal to the plain version")
        del p, w8
    # off the lattice (random bytes: s2 up to 255, sums past an int8) the
    # kernel wraps as the plain version's cast does; not timed
    K, N = shapes["qkv"]

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    p = lin.W4GrpLinear(rand_i8(K // 2, N), rand_i8(K // G, N), rand_i8(K // G, N),
                        torch.rand(N, generator=g, device=dev) * 1e-3)
    a, asc = acts(64, K)
    check("w4a8_gemm_per_group", "random bytes",
          ops.w4a8_gemm_per_group(a, asc, *p, G),
          ops.w4a8_gemm_per_group_plain(a, asc, *p, G))
    log("  w4a8_gemm_per_group [random bytes qkv M=64]: equal to the plain version")
    del p

    # K9: the four linears in bf16, also at M = 8 and a ragged N, and the W8
    # lm_head in f32
    V = LLAMA3_8B["vocab_size"]
    w8_shapes = [(n, k, nn, torch.bfloat16, (64, 2048, 8))
                 for n, (k, nn) in dict(shapes, ragged_n=(4096, 1088)).items()]
    w8_shapes.append(("lm_head", E, V, torch.float32, (64,)))
    for name, K, N, out_dtype, Ms in w8_shapes:
        p = lin.quantize_linear_from_float(weight(K, N), 8)
        for M in Ms:
            a, asc = acts(M, K)
            args = (a, asc, *p, out_dtype)
            err = check("w8a8_gemm", f"{name} M={M}", ops.w8a8_gemm(*args),
                        ops.w8a8_gemm_plain(*args))
            nbytes = (M * K + K * N + 4 * N + 4 * M
                      + M * N * (4 if out_dtype == torch.float32 else 2))
            res.add("w8a8_gemm",
                    f"{name} M={M} K={K} N={N} out={str(out_dtype)[6:]}", err,
                    cuda_ms(lambda: ops.w8a8_gemm(*args)),
                    cuda_ms(lambda: ops.w8a8_gemm_plain(*args)),
                    nbytes, 2 * M * K * N, INT8_OPS,
                    library_or_none(lambda: torch._int_mm(a, p.qweight)))
        del p


def _routed_stream(dev, g, T=2048):
    """A real top-2 routing of T random tokens over Mixtral-8x7B's 8 experts
    (a random router), laid out as the MoE dispatch lays it out: (st, dest,
    block_expert, P, live rows, experts used)."""
    import torch

    from qserve_tpu_torch.kernels import ops
    from qserve_tpu_torch.models import llama

    E, n_exp = MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["num_local_experts"]
    kk = MIXTRAL_8X7B["num_experts_per_tok"]
    x = torch.randn(T, E, generator=g, device=dev).to(torch.bfloat16)
    router = torch.randn(E, n_exp, generator=g, device=dev) * 0.02
    probs = torch.softmax(ops.matmul(x, router.to(torch.bfloat16), torch.float32), -1)
    topi = torch.topk(probs, kk, dim=-1).indices
    st, dest, _, block_expert, P = llama.route_layout(topi, n_exp, 256)
    counts = torch.bincount(topi.reshape(-1), minlength=n_exp).tolist()
    used = sum(c > 0 for c in counts)
    log(f"  routing of {T} tokens: rows per expert {counts}, stream M={P} in "
        f"{P // 256} blocks of 256, block experts {block_expert.tolist()}")
    return st, dest, block_expert, P, T * kk, used


def phase_gemm_routed(res, dev):
    """The routed K2, K8 and K9 against their plain versions, bit for bit,
    at Mixtral-8x7B's gate_up (K 4096, N 28672) and down (K 14336, N 4096)
    over a stream laid out by a real top-2 routing (uneven counts, pad rows,
    an all-pad tail), and the per-group one at the ragged K = 11008. All
    three run the dense kernels' wgmma loop on 128-row tiles, each block
    reading its expert. Beside each: the dense kernel at the same M on one
    expert's weights (no single PyTorch call computes a grouped int8
    product: library null)."""
    import torch

    from qserve_tpu_torch.kernels import ops
    from qserve_tpu_torch.layers import linear as lin

    g = torch.Generator(device=dev).manual_seed(8)
    st, dest, be, M, R, used = _routed_stream(dev, g)
    live = torch.zeros(M, dtype=torch.bool, device=dev)
    live[dest] = True
    n_exp = MIXTRAL_8X7B["num_local_experts"]
    E, I = MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["intermediate_size"]
    shapes = [("gate_up", E, 2 * I), ("down", I, E)]

    def stream(K):
        """int8 rows of the T tokens scattered into the stream; pad rows
        q = 0, scale 0, sum 0."""
        a = torch.zeros(M, K, dtype=torch.int8, device=dev)
        a[dest] = torch.randint(-128, 128, (R, K), generator=g, device=dev,
                                dtype=torch.int8)
        asc = torch.rand(M, 1, generator=g, device=dev) * 0.05 * live[:, None]
        asum = torch.randn(M, 1, generator=g, device=dev) * live[:, None]
        return a, asc, asum

    def check(name, tag, got, want):
        err = (got.float() - want.float()).abs().max().item()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"{name} {tag}: max err {err}"
        assert not got[~live].any(), f"{name} {tag}: pad rows must come out 0"
        return err

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def timed(name, tag, K, N, wbytes, routed, plain, dense):
        err = check(name, tag, routed(), plain())
        nbytes = M * K + used * wbytes + 8 * M + 2 * M * N
        res.add(name, f"{tag} M={M} ({R} live rows, {M // 256} blocks) K={K} N={N}",
                err, cuda_ms(routed, iters=10), cuda_ms(plain, iters=3, warmup=1),
                nbytes, 2 * R * K * N, INT8_OPS, None, dense_ms=cuda_ms(dense, iters=10))

    for tag, K, N in shapes:  # K2 routed: random bytes, as the dense phase
        a, asc, asum = stream(K)
        qw, s1 = rand_i8(n_exp, K // 2, N), torch.rand(n_exp, N, generator=g, device=dev) * 1e-3
        sz = torch.rand(n_exp, N, generator=g, device=dev) * 8e-3
        args = (a, asc, asum, qw, s1, sz, be)
        timed("w4a8_gemm_per_chn_routed", tag, K, N, K // 2 * N + 8 * N,
              lambda: ops.w4a8_gemm_per_chn_routed(*args),
              lambda: ops.w4a8_gemm_per_chn_routed_plain(*args),
              lambda: ops.w4a8_gemm_per_chn(a, asc, asum, qw[0], s1[0], sz[0]))
        del qw, s1, sz, args

    # K8 routed: quantizer-made weights (q * s2 + z2 must fit an int8); the
    # ragged K = 11008 (43 groups a nibble plane) is the TPU's second kernel
    G = 128
    for tag, K, N in shapes + [("ragged down (Llama-2-7B's I)", 11008, E)]:
        a, asc, _ = stream(K)
        ps = [lin.quantize_linear_from_float(
            torch.randn(K, N, generator=g, device=dev) * 0.02, 4, G) for _ in range(n_exp)]
        p = lin.W4GrpLinear(*(torch.stack(x) for x in zip(*ps)))
        del ps
        args = (a, asc, *p, be, G)
        timed("w4a8_gemm_per_group_routed", tag, K, N, K // 2 * N + 2 * (K // G) * N + 4 * N,
              lambda: ops.w4a8_gemm_per_group_routed(*args),
              lambda: ops.w4a8_gemm_per_group_routed_plain(*args),
              lambda: ops.w4a8_gemm_per_group(a, asc, *(x[0] for x in p), G))
        del p, args

    for tag, K, N in shapes:  # K9 routed: 8 experts of W8 gate_up are 939 MB
        a, asc, _ = stream(K)
        qw, ws = rand_i8(n_exp, K, N), torch.rand(n_exp, N, generator=g, device=dev) * 1e-3
        args = (a, asc, qw, ws, be)
        timed("w8a8_gemm_routed", tag, K, N, K * N + 4 * N,
              lambda: ops.w8a8_gemm_routed(*args),
              lambda: ops.w8a8_gemm_routed_plain(*args),
              lambda: ops.w8a8_gemm(a, asc, qw[0], ws[0]))
        del qw, ws, args


def _segments(T, lens):
    seg = np.zeros(T, np.int32)
    t = 0
    for i, n in enumerate(lens):
        seg[t : t + n] = i + 1
        t += n
    return seg


def phase_flash(res, dev):
    import torch
    import torch.nn.functional as F

    from qserve_tpu_torch.kernels import attention

    g = torch.Generator(device=dev).manual_seed(3)
    # 8B: 1948 tokens + 100 padding, as the engine packs; Llama-2-7B: the
    # same without GQA (32 kv heads); a rep of 3 (Hq 6, Hkv 2: 63 of the
    # kernel's 64 folded rows live); then a ragged T with a sliding window
    # and D = 64 (off the main paths)
    cases = [(2048, 32, 8, 128, [700, 512, 436, 300], None),
             (2048, 32, LLAMA2_7B["num_key_value_heads"], 128, [700, 512, 436, 300], None),
             (2048, 6, 2, 128, [700, 512, 436, 300], None),
             (300, 8, 2, 64, [150, 100], 37),
             # head dims 96 and 256 (off the main paths)
             (1024, 8, 2, 96, [600, 400], None),
             (1024, 8, 4, 256, [600, 400], None)]
    for T, Hq, Hkv, D, lens, window in cases:
        seg = torch.from_numpy(_segments(T, lens)).to(dev)
        q = torch.randn(T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        got = attention.prefill_attention(q, k, v, seg, sliding_window=window)
        want = attention.prefill_attention_plain(q, k, v, seg, sliding_window=window)
        valid = seg > 0
        # padding rows attend nothing: the kernel writes exactly 0, the plain
        # version an average of V; neither is read. Live rows: the kernel
        # rounds P to bf16 before PV (relative 2^-9 a key), so the floor is
        # 3e-3 of the largest output, not K4's 1e-3 (the CPU transcription,
        # tests/test_torch_attention_arith.py, needs up to 1.3e-3)
        assert not got[~valid].any(), "padding rows must come out 0"
        tag = f"flash T={T} Hq={Hq} Hkv={Hkv} D={D} window={window}"
        err = hold(tag, got[valid], want[valid], 3e-3)
        # the keys of one 64-key tile of the first prompt zeroed in V
        v_cut = v.clone()
        v_cut[64:128] = 0
        cut = attention.prefill_attention_plain(q, k, v_cut, seg, sliding_window=window)
        has_teeth(tag, cut[valid], want[valid], 3e-3)
        w = window or T
        pairs = sum(sum(min(i + 1, w) for i in range(n)) for n in lens)
        si = torch.arange(T, device=dev)
        mask = ((seg[:, None] == seg[None, :]) & valid[:, None]
                & (si[None, :] <= si[:, None]) & (si[None, :] > si[:, None] - w))
        qs, ks, vs = (x.transpose(0, 1)[None] for x in (q, k, v))
        res.add("flash_prefill_attention",
                f"T={T} Hq={Hq} Hkv={Hkv} D={D} segs={lens} window={window}", err,
                cuda_ms(lambda: attention.prefill_attention(
                    q, k, v, seg, sliding_window=window)),
                cuda_ms(lambda: attention.prefill_attention_plain(
                    q, k, v, seg, sliding_window=window)),
                2 * T * D * 2 * (Hq + Hkv) + 4 * T, 4 * pairs * Hq * D, BF16_OPS,
                library_or_none(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)))


def _paged_case(dev, g, B, H, rep, D, ps, ctx, kv_bits=4, centred=False):
    """One layer of a filled KV4 or KV8 cache (every byte is a valid code in
    both modes) plus the decode inputs. centred: zeros put each head's
    values around 0 (the default's around -0.8: over thousands of keys the
    output is then that offset, and one missing 64-key tile moves it by
    less than one bf16 step)."""
    import torch

    from qserve_tpu_torch.kernels import kv_cache as kvc

    pages_per = [-(-int(c) // ps) for c in ctx]
    P = sum(pages_per) + 1
    cache = kvc.create_kv_cache(1, P, H, ps, D, kv_bits, device=dev)
    cache.data.copy_(torch.randint(-128, 128, cache.data.shape, generator=g,
                                   device=dev, dtype=torch.int8))
    # KV8 codes reach 255, KV4 codes 15: scales keep the values' range
    sc = torch.rand(cache.scales.shape, generator=g, device=dev) * (
        0.2 if kv_bits == 4 else 0.0125)
    sc[:, :, :, H:, :] -= 1.5
    if centred:  # zero = -(middle code) x scale, plus a little noise
        mid = 7.5 if kv_bits == 4 else 127.5
        sc[:, :, :, H:, :] = sc[:, :, :, H:, :] * 0.01 - mid * sc[:, :, :, :H, :]
    cache.scales.copy_(sc)
    perm = torch.randperm(P, generator=g, device=dev).to(torch.int32)
    maxP = max(pages_per)
    bt = torch.zeros(B, maxP, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(pages_per):
        bt[i, :n] = perm[o : o + n]
        o += n
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    q = torch.randn(B, H * rep, D, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    return cache, bt, cl, q, kc, vc


def phase_paged(res, dev):
    import torch
    import torch.nn.functional as F

    from qserve_tpu_torch.kernels import attention, kv_cache as kvc

    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(4)
    small_ctx = np.array([0, 1, 2, 17, 40, 100, 255, 300])
    ctx_8b = rng.integers(512, 1537, 64)
    cases = [
        ("8B", 64, 8, 4, 128, 256, ctx_8b, None, 4),
        ("f32 scales", 8, 2, 2, 64, 16, small_ctx, None, 4),
        ("f32 scales, window 50", 8, 2, 2, 64, 16, small_ctx, 50, 4),
        ("8B KV8", 64, 8, 4, 128, 256, ctx_8b, None, 8),
        ("Llama-2-7B KV8, rep 1", 64, 32, 1, 128, 256, ctx_8b, None, 8),
        ("KV8 f32 scales, window 50", 8, 2, 2, 64, 16, small_ctx, 50, 8),
        # small batches over long histories: the kernel splits each history
        # (values centred on 0: see _paged_case)
        ("B=1 ctx 8192", 1, 8, 4, 128, 256, np.array([8192]), None, 4),
        ("B=8 ctx 4096-8192", 8, 8, 4, 128, 256, rng.integers(4096, 8193, 8), None, 4),
        ("B=1 ctx 8192 KV8", 1, 8, 4, 128, 256, np.array([8192]), None, 8),
        ("B=8 ctx 4096-8192 KV8", 8, 8, 4, 128, 256, rng.integers(4096, 8193, 8), None, 8),
        # head dims 96 and 256; page size 48 copies the scales key by key
        ("D=96", 16, 4, 2, 96, 256, rng.integers(100, 2049, 16), None, 4),
        ("D=96 KV8, ps 48", 16, 4, 2, 96, 48, rng.integers(100, 2049, 16), None, 8),
        ("D=256", 16, 4, 4, 256, 256, rng.integers(100, 2049, 16), None, 4),
        ("D=256 KV8, ps 48, window 300", 16, 4, 4, 256, 48,
         rng.integers(100, 2049, 16), 300, 8),
    ]
    for tag, B, H, rep, D, ps, ctx, window, kv_bits in cases:
        ctx = ctx.tolist()
        cache, bt, cl, q, kc, vc = _paged_case(dev, g, B, H, rep, D, ps, ctx, kv_bits,
                                               centred=tag.startswith("B="))
        assert cache.data.shape[-1] == H * D * kv_bits // 8
        args = (q, cache, bt, cl, 0, kc, vc, kv_bits)
        got = attention.paged_decode_attention(*args, sliding_window=window)
        want = attention.paged_decode_attention_plain(*args, sliding_window=window)
        # q, P and the dequantized values in f32 on both sides: one bf16 step
        # plus 1e-3 of the largest output
        err = hold(f"paged decode {tag}", got, want, 1e-3)
        # the plain output without the last 64 history keys of each row
        # that has more than 64
        cl_cut = torch.where(cl > 65, cl - 64, cl)
        cut = attention.paged_decode_attention_plain(
            q, cache, bt, cl_cut, 0, kc, vc, kv_bits, sliding_window=window)
        has_teeth(f"paged decode {tag}", cut, want, 1e-3)
        # history keys read: positions < ctx-1 within the last window-1
        hist = sum(min(max(c - 1, 0), window - 1 if window else c) for c in ctx)
        sb = cache.scales.element_size()
        nbytes = (2 * hist * H * (D * kv_bits // 8 + 2 * sb) + 2 * B * H * rep * D * 2
                  + 2 * B * H * D * 2 + bt.numel() * 4 + B * 4)
        ops_ = 4 * (hist + B) * H * rep * D
        # yardstick: SDPA over the already dequantized history
        k, v = kvc.gather_dequant_layer(cache.layer(0), bt, kv_bits)
        k = torch.cat([k, kc.float()[:, None]], 1).to(torch.bfloat16).transpose(1, 2)
        v = torch.cat([v, vc.float()[:, None]], 1).to(torch.bfloat16).transpose(1, 2)
        S = k.shape[2]
        pos = torch.arange(S, device=dev)[None]
        h_len = (cl.long() - 1).clamp(min=0)[:, None]
        mask = (pos < h_len) & (pos > h_len - (window or S))
        mask = mask | (pos == S - 1)
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        res.add("paged_decode_attention",
                f"{tag}: KV{kv_bits} B={B} Hq={H * rep} H={H} D={D} ps={ps} "
                f"ctx~{int(np.mean(ctx))} scales={cache.scales.dtype}",
                err,
                cuda_ms(lambda: attention.paged_decode_attention(
                    *args, sliding_window=window)),
                cuda_ms(lambda: attention.paged_decode_attention_plain(
                    *args, sliding_window=window)),
                nbytes, ops_, BF16_OPS,
                library_or_none(lambda: F.scaled_dot_product_attention(
                    qs, k, v, attn_mask=mask, enable_gqa=True)))


def _append_case(dev, g, L, T, H, D, ps, P, kv_bits, extra_rows=0, unaligned=False):
    """A cache of random bytes and a batch's bf16 k/v [L, T, H, D]: views of
    [L, T + extra_rows, H, D] buffers (the mixed step's k_all[:, :T]), or
    of a buffer one element off 16-byte alignment (the scalar path)."""
    import torch

    from qserve_tpu_torch.kernels import kv_cache as kvc

    cache = kvc.create_kv_cache(L, P, H, ps, D, kv_bits, device=dev)
    cache.data.copy_(torch.randint(-128, 128, cache.data.shape, generator=g,
                                   device=dev, dtype=torch.int8))
    kv = []
    for _ in range(2):
        n = (T + extra_rows) * H * D
        flat = torch.randn(L, n + unaligned, generator=g, device=dev).to(torch.bfloat16)
        kv.append(flat[:, int(unaligned):].view(L, T + extra_rows, H, D))
    return cache, kv[0], kv[1]


def _append_is_one_launch(tag, cache, k, v, pg, sl, kv_bits, zp):
    """kv_cache.append_all_layers on CUDA tensors launches K5 once and runs
    no PyTorch op of the plain quantize (profiled on the host)."""
    from torch.profiler import ProfilerActivity, profile

    from qserve_tpu_torch.kernels import _build, kv_cache as kvc

    before = _build.LAUNCHES.get("kv_append", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kvc.append_all_layers(cache, k, v, pg, sl, kv_bits, zp)
    ops = sorted({e.key for e in prof.key_averages()})
    quantize = {"aten::amax", "aten::amin", "aten::round", "aten::clamp", "aten::stack",
                "aten::cat", "aten::div", "aten::bitwise_and", "aten::index_put_"}
    log(f"  kv_append {tag}: append_all_layers made "
        f"{_build.LAUNCHES.get('kv_append', 0) - before} launch; PyTorch ops: {ops}")
    assert _build.LAUNCHES.get("kv_append", 0) - before == 1, tag
    assert not quantize & set(ops), f"{tag}: plain quantize ops ran: {quantize & set(ops)}"


def phase_kv_append(res, dev):
    """K5, the fused quantize-and-append, against its plain chain
    (kv_cache.append_plain: the plain quantize, then the row scatter): data
    and scale bytes equal (tolerance: none) in every case. Timed: the
    kernel (one-call events, and device time from a CUDA graph of 20
    calls), the plain chain, and the plain quantize alone (what the parent
    ran before its row-scatter kernel); peak memory above the inputs of
    the fused and the plain append at the 8B prefill."""
    import torch

    from qserve_tpu_torch.kernels import kv_append, kv_cache as kvc

    g = torch.Generator(device=dev).manual_seed(5)
    L = LLAMA3_8B["num_hidden_layers"]
    cases = []
    # prefill: 4 packed prompts from slot 0 of fresh pages, 100 padding rows
    lens, ps = [700, 512, 436, 300], 256
    pages, slots, p0 = [], [], 0
    for n in lens:
        pages += [p0 + i // ps for i in range(n)]
        slots += [i % ps for i in range(n)]
        p0 += -(-n // ps)
    pages += [-1] * (2048 - len(pages))
    slots += [0] * (2048 - len(slots))
    # decode: 64 tokens, each into its own sequence's last page
    d_pages = list(range(3, 67))
    d_slots = np.random.default_rng(5).integers(0, ps, 64).tolist()
    # (tag, H, D, ps, P, pages, slots, kv_bits, zero_point, extra)
    cases.append(("8B prefill", 8, 128, ps, p0 + 2, pages, slots, 4, True, {}))
    cases.append(("8B decode", 8, 128, ps, 70, d_pages, d_slots, 4, True, {}))
    cases.append(("f32 scales", 2, 64, 16, 12, [0, 5, -1, 7, 11, 2],
                  [0, 15, 3, 9, 1, 4], 4, True, {}))
    cases.append(("8B KV8 decode", 8, 128, ps, 70, d_pages, d_slots, 8, True, {}))
    cases.append(("Llama-2-7B KV8 prefill", 32, 128, ps, p0 + 2, pages, slots, 8, True, {}))
    cases.append(("Llama-2-7B KV8 decode", 32, 128, ps, 70, d_pages, d_slots, 8, True, {}))
    # the mixed step's chunk rows, a strided view of [L, 2048 + 64, H, D]
    cases.append(("8B mixed-step chunk view", 8, 128, ps, p0 + 2, pages, slots, 4, True,
                  dict(extra_rows=64)))
    cases.append(("D=96 prefill", 8, 96, ps, p0 + 2, pages, slots, 4, True, {}))
    cases.append(("D=256 KV8 symmetric prefill", 8, 256, ps, p0 + 2, pages, slots, 8,
                  False, {}))
    cases.append(("8B symmetric decode", 8, 128, ps, 70, d_pages, d_slots, 4, False, {}))
    cases.append(("unaligned view (scalar path)", 8, 128, ps, 70, d_pages, d_slots, 4,
                  True, dict(unaligned=True)))
    for tag, H, D, ps_, P, pg_, sl_, kv_bits, zp, extra in cases:
        T = len(pg_)
        cache, k, v = _append_case(dev, g, L, T, H, D, ps_, P, kv_bits, **extra)
        k, v = k[:, :T], v[:, :T]
        pg = torch.tensor(pg_, dtype=torch.int32, device=dev)
        sl = torch.tensor(sl_, dtype=torch.int32, device=dev)
        ref = kvc.KVCache(cache.data.clone(), cache.scales.clone())
        shape = kv_append.launch_shape(L, T, H, D, kv_bits, not extra.get("unaligned"))
        fused = lambda: kv_append.kv_append(cache.data, cache.scales, k, v, pg, sl,
                                            kv_bits, zp)
        plain = lambda: kvc.append_plain(ref, k, v, pg, sl, kv_bits, zp)
        torch.cuda.synchronize()
        peaks = []
        for fn in (fused, plain):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20)
        assert torch.equal(cache.data, ref.data), f"kv_append ({tag}) data bytes differ"
        assert torch.equal(cache.scales.view(torch.uint8), ref.scales.view(torch.uint8)), \
            f"kv_append ({tag}) scale bytes differ"
        if tag == "8B prefill":
            log(f"  kv_append 8B prefill: peak allocated above the inputs: fused "
                f"{peaks[0]:.1f} MiB, plain chain {peaks[1]:.1f} MiB")
        if tag in ("8B prefill", "8B decode"):  # the engine's entry: one launch
            _append_is_one_launch(tag, cache, k, v, pg, sl, kv_bits, zp)
        if "view" in tag:
            assert not k.is_contiguous()
        valid = int((pg >= 0).sum())
        vec = valid * L * 2 * H  # (layer, token, kv, head) vectors written
        hdc = cache.data.shape[-1] // H
        nbytes = vec * (D * 2 + hdc + 2 * cache.scales.element_size()) + 8 * T
        res.add("kv_append", f"{tag}: KV{kv_bits} zero_point={zp} L={L} T={T} H={H} "
                f"D={D} ps={ps_} scales={cache.scales.dtype} lanes={shape.lanes} "
                f"tb={shape.tb}", 0.0,
                cuda_ms(fused), cuda_ms(plain), nbytes, 6 * vec * D, F32_OPS, None,
                dev_ms=device_ms(fused),
                quantize_ms=cuda_ms(lambda: kvc._quantize_rows(k, v, kv_bits, zp)))
        del cache, ref, k, v


def _prefix_case(dev, g, H, rep, D, ps, prefix_len, T, live, maxP, kv_bits=4):
    """One layer of a cache whose first prefix_len positions were written
    through the port's own append, plus one chunk's inputs."""
    import torch

    from qserve_tpu_torch.kernels import kv_cache as kvc

    P = maxP + 3
    cache = kvc.create_kv_cache(1, P, H, ps, D, kv_bits, device=dev)
    table = torch.randperm(P, generator=g, device=dev)[:maxP].to(torch.int32)
    if prefix_len:
        pk = torch.randn(1, prefix_len, H, D, generator=g, device=dev).to(torch.bfloat16)
        pv = torch.randn(1, prefix_len, H, D, generator=g, device=dev).to(torch.bfloat16)
        s = torch.arange(prefix_len, device=dev)
        kvc.append_all_layers(cache, pk, pv, table[s // ps], (s % ps).to(torch.int32),
                              kv_bits, True)
    q = torch.randn(T, H * rep, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(T, H, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(T, H, D, generator=g, device=dev).to(torch.bfloat16)
    seg = torch.zeros(T, dtype=torch.int32, device=dev)
    seg[:live] = 1
    pos = torch.zeros(T, dtype=torch.int32, device=dev)
    pos[:live] = prefix_len + torch.arange(live, device=dev, dtype=torch.int32)
    return cache, table[None].contiguous(), q, k, v, seg, pos


def phase_prefix(res, dev):
    import torch
    import torch.nn.functional as F

    from qserve_tpu_torch.kernels import attention, kv_cache as kvc

    g = torch.Generator(device=dev).manual_seed(6)
    cases = [
        ("8B", 8, 4, 128, 256, 4096, 2048, 1900, 32, None, 4),
        # a prompt's short last chunk over a long prefix
        ("8B short last chunk", 8, 4, 128, 256, 4096, 512, 452, 32, None, 4),
        ("rep 3 (Hq 6)", 2, 3, 128, 256, 4096, 512, 452, 32, None, 4),
        # a page size that is not a power of two: the kernel divides
        ("page size 48", 2, 4, 128, 48, 500, 128, 120, 12, None, 4),
        ("f32 scales", 2, 2, 64, 16, 97, 80, 70, 12, None, 4),
        ("f32 scales, window 50", 2, 2, 64, 16, 97, 80, 70, 12, 50, 4),
        ("no prefix", 2, 4, 64, 16, 0, 300, 290, 4, None, 4),
        ("8B KV8", 8, 4, 128, 256, 4096, 2048, 1900, 32, None, 8),
        ("Llama-2-7B KV8, rep 1", 32, 1, 128, 256, 2048, 2048, 1900, 16, None, 8),
        ("KV8 f32 scales, window 50", 2, 2, 64, 16, 97, 80, 70, 12, 50, 8),
        # head dims 96 and 256 (off the main paths)
        ("D=96", 2, 4, 96, 256, 1024, 512, 480, 8, None, 4),
        ("D=96 KV8", 2, 4, 96, 256, 1024, 512, 480, 8, None, 8),
        ("D=256", 4, 2, 256, 256, 1024, 512, 480, 8, None, 4),
        ("D=256 KV8", 4, 2, 256, 256, 1024, 512, 480, 8, None, 8),
    ]
    for tag, H, rep, D, ps, S, T, live, maxP, window, kv_bits in cases:
        cache, bt, q, k, v, seg, pos = _prefix_case(dev, g, H, rep, D, ps, S, T,
                                                    live, maxP, kv_bits)
        assert cache.data.shape[-1] == H * D * kv_bits // 8
        args = (q, k, v, seg, pos, cache, bt, S, 0, kv_bits)
        got = attention.prefix_prefill_attention(*args, sliding_window=window)
        want = attention.prefix_prefill_attention_plain(*args, sliding_window=window)
        # padding rows attend nothing: the kernel writes exactly 0, the plain
        # version an average of V; neither is read. Live rows: the kernel
        # rounds p * scale (prefix) and P (chunk) to bf16 for PV, so the
        # floor is 3e-3 of the largest output, as K3's
        assert not got[live:].any(), "padding rows must come out 0"
        err = hold(f"prefix {tag}", got[:live], want[:live], 3e-3)
        if S >= 64:  # the plain version without the prefix's last 64 keys
            cut_args = (q, k, v, seg, pos, cache, bt, S - 64, 0, kv_bits)
            cut = attention.prefix_prefill_attention_plain(*cut_args, sliding_window=window)
            has_teeth(f"prefix {tag}", cut[:live], want[:live], 3e-3)
        if S == 0:  # without a prefix it is the packed prefill kernel's job
            k3 = attention.prefill_attention(q, k, v, seg, sliding_window=window)
            hold(f"prefix {tag} vs flash prefill", got[:live], k3[:live], 3e-3)
        # (query, key) pairs this run's masks let through
        p_live = torch.arange(live, device=dev) + S + 1
        pairs = int((p_live.clamp(max=window) if window else p_live).sum())
        lo = max(0, S - window + 1) if window else 0  # prefix keys any row reads
        sb = cache.scales.element_size()
        nbytes = (2 * (S - lo) * H * (D * kv_bits // 8 + 2 * sb)
                  + 2 * T * D * 2 * (H * rep + H)
                  + 8 * T + 4 * maxP)
        # yardstick: SDPA over the already dequantized prefix + the chunk
        pk, pv = kvc.gather_dequant_layer(cache.layer(0), bt, kv_bits)
        kf = torch.cat([pk[0, :S].to(torch.bfloat16), k]).transpose(0, 1)[None]
        vf = torch.cat([pv[0, :S].to(torch.bfloat16), v]).transpose(0, 1)[None]
        kp = torch.cat([torch.arange(S, device=dev, dtype=torch.int32),
                        torch.where(seg > 0, pos, 2**30)])
        mask = (kp[None, :] <= pos[:, None]) & (seg > 0)[:, None]
        if window:
            mask = mask & (kp[None, :] > pos[:, None] - window)
        mask[live:, 0] = True  # SDPA needs one open key on padding rows
        qs = q.transpose(0, 1)[None]
        res.add("prefix_prefill_attention",
                f"{tag}: KV{kv_bits} T={T} live={live} prefix={S} Hq={H * rep} H={H} D={D} "
                f"ps={ps} window={window} scales={cache.scales.dtype}", err,
                cuda_ms(lambda: attention.prefix_prefill_attention(
                    *args, sliding_window=window), iters=10),
                cuda_ms(lambda: attention.prefix_prefill_attention_plain(
                    *args, sliding_window=window), iters=10),
                nbytes, 4 * pairs * H * rep * D, BF16_OPS,
                library_or_none(lambda: F.scaled_dot_product_attention(
                    qs, kf, vf, attn_mask=mask, enable_gqa=True)))


def sampler_rows(dev, g, B, V):
    """B rows of logits over V and each row's (temperature, top_p, top_k)
    and kind, the index into `kinds` below."""
    import torch

    logits = 3 * torch.randn(B, V, generator=g, device=dev)
    # rows cycle through: greedy, raw temperature, top-k 50, top-p 0.9, both,
    # top-k 1, and top-k 50 with four-way ties at the 50th value; one row
    # alone is "both"
    kinds = [(0.0, 1.0, 0), (0.8, 1.0, 0), (0.8, 1.0, 50), (0.7, 0.9, 0),
             (0.8, 0.9, 50), (1.0, 1.0, 1), (0.8, 1.0, 50)]
    kind = [4] if B == 1 else [i % 7 for i in range(B)]
    temp = torch.tensor([kinds[c][0] for c in kind])
    top_p = torch.tensor([kinds[c][1] for c in kind])
    top_k = torch.tensor([kinds[c][2] for c in kind], dtype=torch.int32)
    tie_rows = [r for r in range(B) if kind[r] == 6]
    for r in tie_rows:  # ranks 50..53 share one value: all four are kept
        order = logits[r].argsort(descending=True)
        logits[r, order[50:53]] = logits[r, order[49]].item()
    return logits, temp, top_p, top_k, kind


def sampler_operands(dev, temp, top_p, top_k, V):
    """What the layer hands the kernel for these rows: (p_eff, k_in) as the
    plain version takes them, (k_eff, p_t) as the kernel does."""
    import torch

    sampling = temp > 0
    filtered = sampling & ((top_k > 0) | (top_p < 1.0))
    p_eff = torch.where(filtered, top_p, 1.0).to(dev)
    k_in = torch.where(filtered, top_k, 0).to(dev)
    k_eff = torch.where(k_in <= 0, V, k_in).to(torch.int32)
    return p_eff, k_in, k_eff, p_eff.clamp(min=1e-9)


def _sampler_case(res, dev, B, V):
    import torch

    from qserve_tpu_torch.kernels import sampler as ksampler
    from qserve_tpu_torch.layers import sampler

    g = torch.Generator(device=dev).manual_seed(7)
    logits, temp, top_p, top_k, kind = sampler_rows(dev, g, B, V)
    tie_rows = [r for r in range(B) if kind[r] == 6]
    noise = -torch.log(-torch.log(
        torch.rand(B, V, generator=g, device=dev).clamp(min=2.0**-24)))

    # the plain version's pieces, on the card
    sampling = temp > 0
    p_eff, k_in, k_eff, p_t = sampler_operands(dev, temp, top_p, top_k, V)
    scaled = logits / temp.clamp(min=1e-6).to(dev)[:, None]
    kept = sampler.threshold_mask(scaled, p_eff, k_in) > -1e29
    sizes = kept.sum(-1)
    assert all(int(sizes[r]) == 53 for r in tie_rows), "ties at the k-th value"
    assert all(int(sizes[r]) == 1 for r in range(B) if kind[r] == 5)
    plain = sampler.sample_filtered_plain(scaled, p_eff, k_in, noise).to(torch.int32)
    want = torch.where(sampling.to(dev), plain, logits.argmax(-1).to(torch.int32))

    # 1. the same noise through the entry point: tokens must be EQUAL
    gen = torch.Generator(device=dev).manual_seed(0)
    got = sampler.sample(logits, temp, top_p, top_k, gen, noise=noise)
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"filtered sampler: {n_diff} of {B} tokens differ from plain"

    # 2. the kernel's own generator: draws stay in the kept sets, reach more
    # than the mode, and repeat for the same (seed, offset)
    rows = torch.arange(B, device=dev)
    draws = torch.stack([
        ksampler.sample_filtered(scaled, k_eff, p_t, True, True, seed=11, offset=i)
        for i in range(300)])
    assert bool(kept[rows[None].expand_as(draws), draws.long()].all()), \
        "a drawn token lies outside threshold_mask's kept set"
    distinct = torch.tensor([draws[:, r].unique().numel() for r in range(B)])
    wide = sizes.cpu() > 1
    assert bool((distinct[wide] > 1).all()) and bool((distinct[~wide] == 1).all())
    again = ksampler.sample_filtered(scaled, k_eff, p_t, True, True, seed=11, offset=7)
    assert torch.equal(again, draws[7]), "same (seed, offset), other tokens"
    # another seed over the same 300 offsets: at B = 1 one offset's draw
    # can repeat by chance
    other = torch.stack([
        ksampler.sample_filtered(scaled, k_eff, p_t, True, True, seed=12, offset=i)
        for i in range(300)])
    assert not torch.equal(other, draws), "the seed does not reach the draw"
    # 3. the draw follows the kept set's softmax: 64 copies of one row,
    # top-k 8, 300 draws each -> 19200 samples, each frequency within 0.02
    one = (3 * torch.randn(1, V, generator=g, device=dev) / 0.8).expand(64, V).contiguous()
    k8 = torch.full((64,), 8, dtype=torch.int32, device=dev)
    p1 = torch.ones(64, device=dev)
    many = torch.stack([
        ksampler.sample_filtered(one, k8, p1, True, False, seed=5, offset=i)
        for i in range(300)]).flatten().long()
    top8 = one[0].topk(8)
    probs = torch.softmax(top8.values, -1)
    freq = torch.stack([(many == t).float().mean() for t in top8.indices])
    ferr = (freq - probs).abs().max().item()
    assert ferr <= 0.02, f"draw frequencies off the softmax by {ferr}"
    log(f"  V={V} own generator: 300 draws in the kept sets, {int(distinct.max())} distinct "
        f"tokens at most per row; top-8 frequencies within {ferr:.3g} of softmax")

    def own():
        return ksampler.sample_filtered(scaled, k_eff, p_t, True, True, seed=3, offset=1)

    def with_noise():
        return ksampler.sample_filtered(scaled, k_eff, p_t, True, True, noise=noise)

    rows = ("both" if B == 1 else
            "greedy, temperature, top-k 50, top-p 0.9, both, top-k 1, ties")
    split = ksampler.cluster_split(V)
    for tag, fn, nbytes in (("", own, B * V * 4 + 12 * B),
                            (" with a noise operand", with_noise, 2 * B * V * 4 + 12 * B)):
        # the noise operand: each kept column's noise read, not the whole row
        if tag:
            nbytes = B * V * 4 + int(sizes.sum()) * 4 + 12 * B
        res.add("sample_filtered",
                f"B={B} V={V} rows: {rows}{tag}; cluster {split.cluster} x "
                f"{split.slice} columns", float(n_diff),
                cuda_ms(fn),
                cuda_ms(lambda: sampler.sample_filtered_plain(scaled, p_eff, k_in, noise),
                        iters=5, warmup=1),
                nbytes, 0, BF16_OPS, None, dev_ms=device_ms(fn))


def phase_sampler(res, dev):
    """K7 at the engine's row counts (1, 8, 16) and at B = 64, over
    Llama-3-8B's and Llama-2-7B's vocabularies; B = 64 at 128256 first, the
    headline row."""
    for B in (64, 1, 8, 16):
        for cfg in (LLAMA3_8B, LLAMA2_7B):
            _sampler_case(res, dev, B, cfg["vocab_size"])


# --------------------------------------------------------------------------
# reference, engine and refusal phases
# --------------------------------------------------------------------------


# the small Mixtral's router probabilities, card vs CPU, on every live token
ROUTER_ATOL = 5e-3


class MoERecorder:
    """While active, every MoE block (models/llama.py `_moe_mlp`) first
    records the length of its token stream, then runs as it would have.
    With probs=True it also keeps the block's router probabilities (f32, on
    the CPU) in probs[side], where the caller sets `side` to "lead" or
    "follow" and runs each step on the leader first. The follower's n-th MoE
    call routes every token whose top-k experts differ from those of the
    leader's n-th call by the leader's experts (the routing weights are the
    follower's own probabilities of those experts), and forced[n] marks those
    tokens: a near-tie that rounding flips then changes no token's experts,
    and the two sides' outputs stay comparable."""

    def __init__(self, probs=False):
        self.keep_probs = probs
        self.rows, self.side = [], "lead"
        self.probs = {"lead": [], "follow": []}
        self.lead_topi, self.forced = [], []

    def __enter__(self):
        import torch

        from qserve_tpu_torch.kernels import ops
        from qserve_tpu_torch.models import llama

        self.real = real = llama._moe_mlp

        def recorded(router, gu_p, down_p, x, args, *rest):
            self.rows.append(x.shape[0])
            if not self.keep_probs:
                return real(router, gu_p, down_p, x, args, *rest)
            logits = ops.matmul(x, router.to(torch.bfloat16), torch.float32)
            p = torch.softmax(logits, -1).cpu()
            self.probs[self.side].append(p)
            own = p.topk(args.moe_top_k, -1).indices
            if self.side == "lead":
                self.lead_topi.append(own)
                return real(router, gu_p, down_p, x, args, *rest)
            lead = self.lead_topi[len(self.probs["follow"]) - 1]
            flip = (own.sort(-1).values != lead.sort(-1).values).any(-1)
            self.forced.append(flip)
            if not flip.any():
                return real(router, gu_p, down_p, x, args, *rest)
            topk = torch.topk  # the one call in _moe_mlp, for this block only

            def lead_topk(probs, k, dim=-1):
                i = topk(probs, k, dim=dim).indices
                i = torch.where(flip[:, None].to(i.device), lead.to(i.device), i)
                return probs.gather(-1, i), i

            torch.topk = lead_topk
            try:
                return real(router, gu_p, down_p, x, args, *rest)
            finally:
                torch.topk = topk

        llama._moe_mlp = recorded
        return self

    def __exit__(self, *exc):
        from qserve_tpu_torch.models import llama

        llama._moe_mlp = self.real


def phase_reference(dev, precision="w4a8kv4", group_size=-1, lm_head_bits=16,
                    moe=False):
    with MoERecorder(probs=moe) as rec:
        _reference(dev, precision, group_size, lm_head_bits, moe, rec)


def _reference(dev, precision, group_size, lm_head_bits, moe, rec):
    """A small model on the card (kernels) and on the CPU (plain versions):
    same params, same packed inputs, logits within 5% of their range, over
    a packed prefill, four decode steps, one chunk step over a cached prefix
    and one mixed chunk+decode step. hidden 256 / intermediate 512 keep K/2
    a multiple of the 128-wide group at every linear. moe: a small Mixtral
    (4 experts, top-2) whose streams of 16 rows or more take the routed
    GEMMs in 128-row blocks (prefill, chunk, mixed) and shorter ones the
    masked loop (decode). Each step runs on the card first; the CPU's MoE
    blocks then give a token whose top-2 experts differ from the card's the
    card's experts (MoERecorder), so a near-tie flipped by rounding leaves
    every step's logits comparable, and all of them are held. The prefill
    attention kernels round P to bf16 as the TPU kernels did, and the int8
    activation quantizers turn that ~1e-3 into whole-code steps, so the two
    sides' router inputs part by more than an ulp: the router probabilities
    of every live token of every MoE call must agree within ROUTER_ATOL (the
    H100 has read up to 4.1e-3 over the eight steps; K3's arithmetic
    transcribed on the CPU moves them by up to 2.5e-3 in the prefill alone,
    tests/test_torch_attention_arith.py), which also bounds the top-2 margin
    of any token whose experts differ: at most the two edge probabilities'
    movement, 1e-2."""
    import torch

    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.kernels import _build, kv_cache as kvc
    from qserve_tpu_torch.models import llama, mixtral

    quant = QuantSpec.from_precision(precision, group_size, lm_head_bits=lm_head_bits)
    geo = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
               num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    if moe:
        geo.update(num_experts=4, moe_top_k=2, moe_route_block=128,
                   moe_route_min_tokens=16)
    args = llama.LlamaArgs(quant=quant, **geo)
    tag = f"{'Mixtral ' if moe else ''}{precision} group {group_size} lm_head W{lm_head_bits}"
    before = dict(_build.LAUNCHES)

    def to(x, d):  # a tensor, or a (nested) NamedTuple of tensors
        if isinstance(x, torch.Tensor):
            return x.to(d)
        return type(x)(*(to(y, d) for y in x))

    cpu = (mixtral if moe else llama).random_quantized_params(0, args, device="cpu")
    gpu = to(cpu, dev)
    ps, lens, T = 16, [37, 20], 64
    rng = np.random.default_rng(7)
    tok = np.zeros(T, np.int32)
    tok[:57] = rng.integers(1, 512, 57)
    pos = np.concatenate([np.arange(37), np.arange(20), np.zeros(7)]).astype(np.int32)
    seg = _segments(T, lens)
    pages = np.array([i // ps for i in range(37)] + [3 + i // ps for i in range(20)]
                     + [-1] * 7, np.int32)
    slots = np.concatenate([np.arange(37) % ps, np.arange(20) % ps, np.zeros(7)]).astype(np.int32)
    last = np.array([36, 56], np.int32)
    caches = {d: kvc.create_kv_cache(2, 10, 2, ps, 64, quant.kv_bits, device=d)
              for d in ("cpu", dev)}
    params = {"cpu": cpu, dev: gpu}
    worst, flips, moved, routed = 0.0, [], [], set()
    seen = 0

    def both(fn):
        """fn(device) on the card, then on the CPU, whose MoE blocks follow
        the card's routing."""
        outs = {}
        for d, side in ((dev, "lead"), ("cpu", "follow")):
            rec.side = side
            outs[d] = fn(d)
        return outs

    def check_routing(live):
        """The MoE calls since the last look: router probabilities within
        ROUTER_ATOL on the live tokens, and the CPU's top-2 margin of each live
        token that took the card's experts. Padding rows are left out: their
        attention output differs by design (the kernels write 0, the plain
        versions an average of V) and nothing reads them."""
        nonlocal seen
        pd, pc = rec.probs["lead"], rec.probs["follow"]
        assert len(pc) == len(pd), "the two sides ran other MoE calls"
        live = torch.from_numpy(np.asarray(live, bool))
        k, step = args.moe_top_k, 0.0
        for c, d, forced in zip(pc[seen:], pd[seen:], rec.forced[seen:]):
            assert c.shape[0] == live.shape[0], (c.shape, live.shape)
            dp = (c - d)[live].abs().max().item()
            assert dp < ROUTER_ATOL, f"router probabilities differ by {dp:.3g}"
            step = max(step, dp)
            if (forced & live).any():
                srt = c[forced & live].sort(-1, descending=True).values
                flips.extend(round(x, 6) for x in (srt[:, k - 1] - srt[:, k]).tolist())
        seen = len(pc)
        moved.append(round(step, 6))

    def compare(outs, live):
        """live: the step's stream rows that are real tokens."""
        nonlocal worst
        a, b = outs["cpu"], outs[dev].cpu()
        assert torch.isfinite(b).all()
        rel = (a - b).abs().max().item() / a.abs().max().item()
        if moe:
            routed.update(r for r in rec.rows if r >= args.moe_route_min_tokens)
            check_routing(live)
        worst = max(worst, rel)
        assert rel <= 0.05, f"card vs CPU logits differ by {rel:.3g} of their range"
        return a

    inp = (tok, pos, seg, pages, slots, last)
    outs = both(lambda d: llama.prefill(params[d], caches[d],
                                        *(torch.from_numpy(x).to(d) for x in inp), args)[0])
    logits = compare(outs, seg > 0)
    bt = np.array([[0, 1, 2], [3, 4, 0]], np.int32)
    for step in range(4):
        tok_d = logits.argmax(-1).to(torch.int32).numpy()
        ctx = np.array([38 + step, 21 + step], np.int32)
        outs = both(lambda d: llama.decode(
            params[d], caches[d], *(torch.from_numpy(x).to(d) for x in (tok_d, bt, ctx)),
            args)[0])
        logits = compare(outs, ctx > 0)
    # one chunk step: a third prompt whose first 32 tokens (two pages) are
    # cached by a prefill, then tokens 32..52 as a chunk over that prefix
    ids3 = rng.integers(1, 512, 53).astype(np.int32)

    def packed(ids, start, T, table):
        n = len(ids)
        p = start + np.arange(n)
        pad = T - n
        z = np.zeros(pad, np.int32)
        return tuple(np.concatenate([a.astype(np.int32), b]) for a, b in (
            (ids, z), (p, z), (np.ones(n), z),
            (np.asarray(table)[p // ps], z - 1), (p % ps, z))) + (
            np.array([n - 1], np.int32),)

    table3 = [5, 6, 7, 8]
    bt3 = np.array([table3], np.int32)
    outs = both(lambda d: llama.prefill(params[d], caches[d],
                                        *(torch.from_numpy(x).to(d)
                                          for x in packed(ids3[:32], 0, 32, table3)), args)[0])
    compare(outs, np.ones(32, bool))
    outs = both(lambda d: llama.prefill_chunk(
        params[d], caches[d],
        *(torch.from_numpy(x).to(d) for x in packed(ids3[32:45], 32, 16, table3)),
        torch.from_numpy(bt3).to(d), 32, args)[0])
    compare(outs, np.arange(16) < 13)
    # one mixed step: the rest of that prompt (prefix 45, not page-aligned)
    # riding with the two decoding sequences and one pad row
    tok_d = np.concatenate([logits.argmax(-1).to(torch.int32).numpy(), [0]]).astype(np.int32)
    bt_d = np.array([[0, 1, 2, 0], [3, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    ctx_d = np.array([42, 25, 0], np.int32)
    outs = both(lambda d: llama.prefill_chunk_with_decode(
        params[d], caches[d],
        *(torch.from_numpy(x).to(d) for x in packed(ids3[45:], 45, 16, table3)),
        torch.from_numpy(bt3).to(d), 45,
        *(torch.from_numpy(x).to(d) for x in (tok_d, bt_d, ctx_d)), args)[0])
    assert outs[dev].shape == (4, 512)
    compare({d: o[:3] for d, o in outs.items()},  # row 3 is the pad row
            np.concatenate([np.arange(16) < 8, ctx_d > 0]))
    ran = sorted(k for k, v in _build.LAUNCHES.items() if v > before.get(k, 0))
    log(f"  reference {tag}: card vs CPU logits over prefill, 4 decode steps, a "
        f"chunk step and a mixed step, worst max|diff| / max|logit| = {worst:.3g}; "
        f"kernels: {ran}")
    if moe:
        log(f"    routed streams of {sorted(routed)} rows; router probabilities differ "
            f"by up to {max(moved):.3g} (by step {moved}); {len(flips)} live tokens took "
            f"the card's experts (CPU top-2 margins {flips}); all {len(moved)} steps held")
        assert routed, "no step took the routed dispatch"
        if quant.act_bits == 8:
            want = {(4, -1): "w4a8_gemm_per_chn_routed", (8, -1): "w8a8_gemm_routed"}.get(
                (quant.weight_bits, group_size), "w4a8_gemm_per_group_routed")
            assert want in ran, f"{want} did not launch"


def _drive(engine, want_tokens, arrivals=(), vocab=LLAMA3_8B["vocab_size"], moe=None):
    """Step the engine until idle. arrivals: [(after_step, fn)], fn adds
    requests once that many steps have run. Returns per-kind step times and
    launch deltas, and checks every finished request. moe: a MoERecorder
    whose stream lengths label each step's launches in `log`."""
    import torch

    from qserve_tpu_torch.kernels import _build

    arrivals = sorted(arrivals, key=lambda a: a[0])
    ms, per_kind, finished, tokens_out, steps, step_log = {}, {}, 0, 0, 0, []
    streams = {}  # request id -> its output token ids
    dev_ms = {}  # CUDA events on the stream around each step's launches
    peak = {}  # torch.cuda.max_memory_allocated over each step
    t_run = time.perf_counter()
    while engine.has_unfinished_requests() or arrivals:
        while arrivals and (arrivals[0][0] <= steps
                            or not engine.has_unfinished_requests()):
            arrivals.pop(0)[1]()
        before = dict(_build.LAUNCHES)
        if moe is not None:
            moe.rows.clear()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ev0.record()
        outs = engine.step()
        ev1.record()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        steps += 1
        kind = engine.last_step_kind
        ms.setdefault(kind, []).append(dt)
        dev_ms.setdefault(kind, []).append(ev0.elapsed_time(ev1))
        peak.setdefault(kind, []).append(torch.cuda.max_memory_allocated() / 2**30)
        delta = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                 if v - before.get(k, 0)}
        per_kind.setdefault(kind, delta)
        if moe is not None:
            assert len(set(moe.rows)) == 1, f"a step of streams {set(moe.rows)}"
            step_log.append((kind, moe.rows[0], len(moe.rows), dt, delta))
        for out in outs:
            if out.finished:
                finished += 1
                toks = out.outputs[0]["token_ids"]
                assert len(toks) == want_tokens[out.request_id], \
                    f"{out.request_id}: {len(toks)} tokens"
                assert all(0 <= x < vocab for x in toks)
                tokens_out += len(toks)
                streams[out.request_id] = list(toks)
    run_s = time.perf_counter() - t_run
    assert finished == len(want_tokens), \
        f"{finished} of {len(want_tokens)} requests finished"
    return dict(ms=ms, dev_ms=dev_ms, peak=peak, per_kind=per_kind, finished=finished,
                tokens_out=tokens_out, run_s=run_s, log=step_log, streams=streams)


def _report(tag, r, launches):
    log(f"  {tag}: {r['finished']} requests finished, {r['tokens_out']} tokens out, "
        f"run {r['run_s']:.2f} s, output {r['tokens_out'] / r['run_s']:.1f} tok/s")
    for kind, ts in r["ms"].items():
        dv = r["dev_ms"][kind]
        log(f"    {len(ts)} {kind} steps: median {statistics.median(ts):.2f} ms, "
            f"min {min(ts):.2f}, max {max(ts):.2f} (host clock); device "
            f"{statistics.median(dv):.2f} ms median (CUDA events); peak allocated "
            f"{max(r['peak'][kind]):.3f} GiB; launches in the first: {r['per_kind'][kind]}")
    log(f"    launches in the run: {launches}")
    return dict(
        finished=r["finished"], tokens_out=r["tokens_out"], run_s=r["run_s"],
        output_tok_s=r["tokens_out"] / r["run_s"],
        steps={k: len(v) for k, v in r["ms"].items()},
        step_ms_median={k: statistics.median(v) for k, v in r["ms"].items()},
        step_device_ms_median={k: statistics.median(v) for k, v in r["dev_ms"].items()},
        step_peak_gib={k: max(v) for k, v in r["peak"].items()},
        step_ms={k: [round(x, 2) for x in v] for k, v in r["ms"].items()
                 if k != "decode"},
        launches_per_step={k: v for k, v in r["per_kind"].items()},
    )


def _build_engine(dev, tag, cfg, **kw):
    import torch

    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    t0 = time.perf_counter()
    engine = EngineArgs(
        hf_config=cfg, random_weights=True, seed=0, device=dev, block_size=256,
        max_num_batched_tokens=2048, max_num_seqs=64, **kw,
    ).build_engine()
    sc = engine.scheduler.scheduler_config
    assert sc.enable_chunked_prefill and sc.mixed_chunk_decode, "default scheduler"
    torch.cuda.synchronize()
    cache = engine.worker.cache_engine.cache
    log(f"  {tag}: engine built in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; cache rows "
        f"of {cache.data.shape[-1]} bytes, {cache.num_kv_heads} kv heads)")
    return engine


def _release():
    """Return a deleted engine's weights and cache to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")


PATH_A_GREEDY = [f"a{i}" for i in range(6)]  # a6 and a7 sample at temperature 0.8


def _add_path_a(engine, prefix="a"):
    """Path a's 8 requests (the same prompts each call); returns
    {request id: output tokens}."""
    from qserve_tpu_torch.sampling_params import SamplingParams

    V = LLAMA3_8B["vocab_size"]
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, 8)
    for i, n in enumerate(lens):
        engine.add_request(
            f"{prefix}{i}", prompt_token_ids=rng.integers(0, V, int(n)).tolist(),
            sampling_params=SamplingParams(
                max_tokens=32, ignore_eos=True, temperature=0.8 if i >= 6 else 0.0))
    return {f"{prefix}{i}": 32 for i in range(8)}, lens


def _path_a(engine, tag="path a"):
    """Whole-prompt prefill + paged decode. Returns (launches, summary,
    {request id: tokens})."""
    from qserve_tpu_torch.kernels import _build

    want, lens = _add_path_a(engine)
    log(f"  {tag}: 8 requests, prompt lengths {lens.tolist()}, 32 output tokens each")
    _build.reset_launch_counts()
    ra = _drive(engine, want)
    launches_a = dict(_build.LAUNCHES)
    summary_a = _report(tag, ra, launches_a)
    _require_path_a(tag, launches_a)
    assert set(ra["ms"]) == {"prefill", "decode"}, set(ra["ms"])
    return launches_a, summary_a, ra["streams"]


def _require_path_a(tag, launches):
    _require(tag, launches,
             ran=("elementwise", "w4a8_gemm_per_chn", "flash_prefill_attention",
                  "paged_decode_attention", "kv_append"),
             idle=("w4a8_gemm_per_group", "w8a8_gemm") + ROUTED_GEMMS)


def _require(tag, launches, ran, idle=()):
    missing = [k for k in ran if launches.get(k, 0) == 0]
    assert not missing, f"kernels never launched on {tag}: {missing}"
    stray = [k for k in idle if launches.get(k, 0)]
    assert not stray, f"{tag} launched kernels of another precision: {stray}"


def _path_b(engine):
    """Chunked prefill, mixed steps, prefix skip, top-k/top-p."""
    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.sampling_params import SamplingParams

    V = LLAMA3_8B["vocab_size"]

    def sp(i, n):
        if i % 2:
            return SamplingParams(max_tokens=n, ignore_eos=True, temperature=0.8,
                                  top_p=0.9, top_k=50)
        return SamplingParams(max_tokens=n, ignore_eos=True, temperature=0.0)

    rng = np.random.default_rng(1)
    lens = rng.integers(128, 1025, 7)
    shared = rng.integers(0, V, 768).tolist()  # three pages of shared prefix
    want = {}
    for i, n in enumerate(lens):
        want[f"b{i}"] = 48
        ids = rng.integers(0, V, int(n)).tolist()
        if i == 0:  # b0 computes the shared prefix
            ids = shared + ids[:100]
        engine.add_request(f"b{i}", prompt_token_ids=ids, sampling_params=sp(i, 48),
                           prefix_pos=768 if i == 0 else None)
    long_len = 6000

    def add_long():
        want["long"] = 16
        engine.add_request("long", prompt_token_ids=rng.integers(0, V, long_len).tolist(),
                           sampling_params=sp(1, 16))
        want["skip"] = 16  # shares b0's computed prefix, rides with the decodes
        engine.add_request("skip", prompt_token_ids=shared + rng.integers(0, V, 200).tolist(),
                           sampling_params=sp(0, 16), prefix_pos=768)

    def add_alone():
        want["alone"] = 8  # the same prefix with nothing else running
        engine.add_request("alone", prompt_token_ids=shared + rng.integers(0, V, 300).tolist(),
                           sampling_params=sp(1, 8), prefix_pos=768)

    log(f"  path b: 7 requests, prompt lengths {[868] + lens[1:].tolist()}, 48 output "
        f"tokens; after 8 steps a {long_len}-token prompt and a prefix-sharing one; "
        f"last a prefix-sharing one alone; odd requests at temperature 0.8, "
        f"top_p 0.9, top_k 50")
    _build.reset_launch_counts()
    rb = _drive(engine, want, [(8, add_long), (10**9, add_alone)])
    launches_b = dict(_build.LAUNCHES)
    summary_b = _report("path b", rb, launches_b)
    idle = ("w4a8_gemm_per_group", "w8a8_gemm") + ROUTED_GEMMS
    _require("path b", launches_b, ran=[k for k in ROUTES if k not in idle], idle=idle)
    assert len(rb["ms"].get("mixed", [])) >= 4, "the long prompt did not admit in mixed steps"
    assert rb["ms"].get("chunk"), "no chunk step ran alone"
    return launches_b, summary_b


def _path_mixed(engine, tag, vocab, seed, ran, idle, moe=None):
    """Paths c-i: 6 requests decode; after 4 steps a 3000-token prompt
    admits beside them in two mixed steps; when all is done a 2500-token
    prompt runs alone (its first chunk a prefill step, its second a chunk
    step over the cached first). One request samples at temperature 0.8
    with top-k/top-p. moe: (recorder, dense GEMM, routed GEMM) of a Mixtral
    path, whose launches are checked step by step."""
    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.sampling_params import SamplingParams

    def sp(n, filtered=False):
        if filtered:
            return SamplingParams(max_tokens=n, ignore_eos=True, temperature=0.8,
                                  top_p=0.9, top_k=50)
        return SamplingParams(max_tokens=n, ignore_eos=True, temperature=0.0)

    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 1025, 6)
    want = {}
    for i, n in enumerate(lens):
        want[f"{tag}{i}"] = 24
        engine.add_request(f"{tag}{i}", prompt_token_ids=rng.integers(0, vocab, int(n)).tolist(),
                           sampling_params=sp(24, filtered=i == 5))

    def add_long():
        want[f"{tag}long"] = 8
        engine.add_request(f"{tag}long", prompt_token_ids=rng.integers(0, vocab, 3000).tolist(),
                           sampling_params=sp(8))

    def add_alone():
        want[f"{tag}alone"] = 4
        engine.add_request(f"{tag}alone", prompt_token_ids=rng.integers(0, vocab, 2500).tolist(),
                           sampling_params=sp(4))

    log(f"  path {tag}: 6 requests, prompt lengths {lens.tolist()}, 24 output tokens; "
        f"after 4 steps a 3000-token prompt; last a 2500-token prompt alone")
    _build.reset_launch_counts()
    r = _drive(engine, want, [(4, add_long), (10**9, add_alone)], vocab=vocab,
               moe=moe and moe[0])
    launches = dict(_build.LAUNCHES)
    summary = _report(f"path {tag}", r, launches)
    _require(f"path {tag}", launches, ran, idle)
    assert {"prefill", "mixed", "chunk", "decode"} <= set(r["ms"]), set(r["ms"])
    assert len(r["ms"]["mixed"]) >= 2, "the long prompt did not admit in mixed steps"
    if moe:
        summary["moe_steps"] = _check_moe_steps(tag, r["log"], *moe[1:])
    return launches, summary


def _check_moe_steps(tag, step_log, dense, routed, min_rows=1024, n_exp=8):
    """A Mixtral step of min_rows or more runs the routed GEMMs (gate_up and
    down, 2 a layer) and the dense kernel for qkv and o only; a shorter one
    runs no routed GEMM and the dense kernel 2 + 2 * n_exp times a layer
    (qkv, o, each expert's gate_up and down). Returns [(kind, rows, ms)]."""
    kinds = set()
    for kind, rows, L, dt, delta in step_log:
        got = (delta.get(dense, 0), delta.get(routed, 0))
        want = (2 * L, 2 * L) if rows >= min_rows else ((2 + 2 * n_exp) * L, 0)
        assert got == want, (f"path {tag}: a {kind} step of {rows} rows launched "
                             f"{dense} {got[0]}, {routed} {got[1]} times; want {want}")
        kinds.add((kind, rows >= min_rows))
    log(f"    MoE dispatch by step: " + ", ".join(
        f"{kind} {rows} rows {'routed' if rows >= min_rows else 'masked'} {dt:.1f} ms"
        for kind, rows, _, dt, _ in step_log if kind != "decode")
        + f"; {sum(k == 'decode' for k, *_ in step_log)} decode steps masked")
    assert any(r for _, r in kinds) and any(not r for _, r in kinds), kinds
    return [(kind, rows, round(dt, 2)) for kind, rows, _, dt, _ in step_log]


def _param_gib(params):
    """GiB of a (nested) NamedTuple of tensors."""
    import torch

    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size() / 2**30
    return sum(_param_gib(p) for p in params)


def phase_engine(dev):
    """Paths a-i. Returns ({path: launches}, {path: summary})."""
    import torch

    launches, summary = {}, {}
    common = ("elementwise", "flash_prefill_attention", "paged_decode_attention",
              "kv_append", "prefix_prefill_attention", "sample_filtered")

    engine = _build_engine(dev, "paths a, b (Llama-3-8B w4a8kv4 per-channel)",
                           LLAMA3_8B, precision="w4a8kv4", group_size=-1,
                           max_model_len=8192, num_device_pages=160)
    launches["a"], summary["path_a"], streams_a = _path_a(engine)
    log("phase checkpoint")
    t = time.perf_counter()
    ck_launches, summary["checkpoint"] = phase_checkpoint(dev, engine, streams_a)
    launches.update(ck_launches)
    log(f"  phase checkpoint ok in {time.perf_counter() - t:.1f} s")
    launches["b"], summary["path_b"] = _path_b(engine)
    del engine
    _release()

    engine = _build_engine(dev, "path c (Llama-3-8B w4a8kv4 g128, W8 lm_head)",
                           LLAMA3_8B, precision="w4a8kv4", group_size=128,
                           quant_lm_head=True, max_model_len=8192,
                           num_device_pages=160)
    launches["c"], summary["path_c"] = _path_mixed(
        engine, "c", LLAMA3_8B["vocab_size"], 2,
        ran=common + ("w4a8_gemm_per_group", "w8a8_gemm"),
        idle=("w4a8_gemm_per_chn",) + ROUTED_GEMMS)
    del engine
    _release()

    engine = _build_engine(dev, "path d (Llama-2-7B w4a8kv8 g128)",
                           LLAMA2_7B, precision="w4a8kv8", group_size=128,
                           max_model_len=4096, num_device_pages=96)
    cache = engine.worker.cache_engine.cache
    assert cache.data.shape[-1] == 32 * 128, "KV8 rows of 32 kv heads"
    launches["d"], summary["path_d"] = _path_mixed(
        engine, "d", LLAMA2_7B["vocab_size"], 3,
        ran=common + ("w4a8_gemm_per_group",),
        idle=("w4a8_gemm_per_chn", "w8a8_gemm") + ROUTED_GEMMS)
    del cache
    del engine
    _release()

    engine = _build_engine(dev, "path e (Llama-3-8B w8a8kv8)",
                           LLAMA3_8B, precision="w8a8kv8", max_model_len=8192,
                           num_device_pages=160)
    cache = engine.worker.cache_engine.cache
    assert cache.data.shape[-1] == 8 * 128, "KV8 rows of 8 kv heads"
    launches["e"], summary["path_e"] = _path_mixed(
        engine, "e", LLAMA3_8B["vocab_size"], 4,
        ran=common + ("w8a8_gemm",),
        idle=("w4a8_gemm_per_chn", "w4a8_gemm_per_group") + ROUTED_GEMMS)
    del cache
    del engine
    _release()

    # W16A16: norms and products are library calls (as XLA ran them beside
    # the TPU kernels), so K3-K7 launch and neither K1 nor any GEMM kernel
    engine = _build_engine(dev, "path f (Llama-3-8B w16a16kv8)",
                           LLAMA3_8B, precision="w16a16kv8", max_model_len=8192,
                           num_device_pages=160)
    assert engine.worker.model_runner.params.layers.qkv.weight.dtype == torch.bfloat16
    launches["f"], summary["path_f"] = _path_mixed(
        engine, "f", LLAMA3_8B["vocab_size"], 5, ran=common[1:],
        idle=("elementwise",) + DENSE_GEMMS + ROUTED_GEMMS)
    del engine
    _release()

    # Mixtral-8x7B: the MoE layers at three precisions, W8A8 last (~47 GB of
    # weights); each path's routed GEMM launches on its steps of 1024 rows
    # or more, the other precisions' GEMMs never
    for tag, precision, group_size, dense, routed in (
            ("g", "w4a8kv4", -1, "w4a8_gemm_per_chn", "w4a8_gemm_per_chn_routed"),
            ("h", "w4a8kv4", 128, "w4a8_gemm_per_group", "w4a8_gemm_per_group_routed"),
            ("i", "w8a8kv8", -1, "w8a8_gemm", "w8a8_gemm_routed")):
        engine = _build_engine(dev, f"path {tag} (Mixtral-8x7B {precision} group {group_size})",
                               MIXTRAL_8X7B, precision=precision, group_size=group_size,
                               max_model_len=8192, num_device_pages=160)
        params = engine.worker.model_runner.params
        gu = params.layers.gate_up
        assert gu.qweight.shape[:2] == (32, 8), "[L, NE] expert weights"
        log(f"    weights {_param_gib(params):.3f} GiB, of which experts "
            f"{_param_gib((gu, params.layers.down)):.3f} GiB")
        del params, gu
        with MoERecorder() as rec:
            launches[tag], summary[f"path_{tag}"] = _path_mixed(
                engine, tag, MIXTRAL_8X7B["vocab_size"], 6,
                ran=common + (dense, routed),
                idle=tuple(k for k in DENSE_GEMMS + ROUTED_GEMMS if k not in (dense, routed)),
                moe=(rec, dense, routed))
        del engine
        _release()
    return launches, summary


# --------------------------------------------------------------------------
# checkpoint phase
# --------------------------------------------------------------------------


def _leaves(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for y in x for leaf in _leaves(y)]


def _same_bits(tag, got, want):
    """Every leaf of two params trees equal bit for bit (dtype and shape
    too); returns the bytes compared."""
    import torch

    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), f"{tag}: {len(g)} leaves against {len(w)}"
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{tag}: leaf {i} is {a.dtype} {tuple(a.shape)}, want {b.dtype} {tuple(b.shape)}"
        assert torch.equal(a, b.to(a.device)), f"{tag}: leaf {i} {tuple(a.shape)} differs"
    return sum(t.numel() * t.element_size() for t in w)


def _ckpt_dir(tag, need_bytes):
    """A directory for checkpoint files inside the checkout (gitignored),
    once the disk is shown to have room for them."""
    import os
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    free = shutil.disk_usage(root).free
    log(f"  {tag}: {need_bytes / 1e9:.2f} GB to write, {free / 1e9:.1f} GB free on the disk")
    if free < need_bytes + (2 << 30):
        raise RuntimeError(f"checkpoint phase: {tag} needs {need_bytes / 1e9:.2f} GB "
                           f"(+2 GiB spare) on disk, {free / 1e9:.2f} GB free under {root}")
    return tempfile.mkdtemp(prefix=f".chip_smoke_ckpt_{tag}_", dir=root)


def _has(module):
    import importlib.util

    return importlib.util.find_spec(module) is not None


def _write_config(d, cfg):
    import os

    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(cfg, architectures=["LlamaForCausalLM"]), f)


def _ckpt_engine(dev, model, **kw):
    import torch

    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = EngineArgs(model=model, device=dev, block_size=256, max_num_batched_tokens=2048,
                        max_num_seqs=64, max_model_len=8192, num_device_pages=160,
                        **kw).build_engine()
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


class _DecodeWatch:
    """Wraps a runner's execute_decode: records each decode step's
    (sequence order, sampled ids) in device feed, and every wait for the
    card its launches made, as torch.cuda.set_sync_debug_mode("warn")
    reports them (source line and message); prefill steps are not watched
    (they read their ids back by design)."""

    def __init__(self, runner):
        self.runner, self.real = runner, runner.execute_decode
        self.steps, self.waits = [], []
        runner.execute_decode = self

    def __call__(self, md, cache_engine):
        import warnings

        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.real(md, cache_engine)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.waits += [f"{w.filename}:{w.lineno}: {str(w.message).splitlines()[0]}"
                       for w in caught if "called a synchronizing" in str(w.message)]
        if getattr(self.runner, "benchmarking", False):
            self.steps.append((self.runner._prev_order, self.runner._prev_toks.clone()))
        return out

    def close(self):
        self.runner.execute_decode = self.real


def _chain(engine, steps, outputs):
    """{request id: tokens} of a device-fed run: each request's prefill
    token, then the ids each decode step sampled and kept on the card."""
    chain = {rid: [toks[0]] for rid, toks in outputs.items()}
    req = {sid: g.request_id for sid, (g, _) in engine._seq_index.items()}
    for order, toks in steps:
        for sid, t in zip(order, toks.cpu().tolist()):
            chain[req[sid]].append(t)
    return chain


def _decode_round(engine, prefix, profile=False):
    """Path a's requests with no synchronize between steps (as a server
    steps). Returns per decode step (host ms, CUDA-event ms), the run's
    host seconds, and with profile the card's busy ms over the decode steps
    after the first (torch.profiler, kernels only) and their wall ms."""
    import torch

    want, _ = _add_path_a(engine, prefix)
    torch.cuda.synchronize()
    host, events, prof, t_dec = [], [], None, None
    t_run = time.perf_counter()
    while engine.has_unfinished_requests():
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        ev0.record()
        engine.step()
        ev1.record()
        dt = (time.perf_counter() - t) * 1e3
        if engine.last_step_kind == "decode":
            host.append(dt)
            events.append((ev0, ev1))
            if profile and prof is None:  # from the second decode step on
                import torch.profiler as tp

                prof = tp.profile(activities=[tp.ProfilerActivity.CPU,
                                              tp.ProfilerActivity.CUDA])
                prof.start()
                t_dec = time.perf_counter()
    torch.cuda.synchronize()
    end = time.perf_counter()
    out = dict(host_ms=host, event_ms=[a.elapsed_time(b) for a, b in events],
               run_s=end - t_run, requests=len(want))
    if prof is not None:
        prof.stop()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA"))
        out.update(busy_ms=busy_us / 1e3, wall_ms=(end - t_dec) * 1e3)
    return out


def _text_on_card(model_dir, vocab):
    """e2e_generation's main() on the card: a word-level tokenizer of
    `vocab` entries saved beside the weights (built here with the tokenizers
    library, offline; the port's get_tokenizer loads it), the
    default prompts through the chat template, the default sampling
    (temperature 0.7, top-p 0.9: the filtered sampler), 16 tokens each."""
    import contextlib
    import io
    import re

    import os

    from tokenizers import Tokenizer, models, pre_tokenizers

    from qserve_tpu_torch.entrypoints import e2e_generation
    from qserve_tpu_torch.kernels import _build

    words = sorted(set(re.findall(r"\w+|[^\w\s]+", " ".join(e2e_generation.DEFAULT_PROMPTS))))
    table = ["<unk>", "<s>", "</s>"] + words
    table += [f"w{i}" for i in range(vocab - len(table))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(table)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(model_dir, "tokenizer.json"))
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump(dict(tokenizer_class="PreTrainedTokenizerFast", unk_token="<unk>",
                       bos_token="<s>", eos_token="</s>"), f)
    argv = ["e2e_generation", "--model", model_dir, "--max-tokens", "16",
            "--num-device-pages", "64", "--max-model-len", "2048"]
    out, saved = io.StringIO(), sys.argv
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sys.argv = argv
        with contextlib.redirect_stdout(out):
            e2e_generation.main()
    finally:
        sys.argv = saved
    launches = dict(_build.LAUNCHES)
    text = out.getvalue()
    blocks = text.split("\n=== request ")[1:]
    outputs = re.findall(r"\[output\] (.*)", text)
    log(f"  text: e2e_generation on the card in {time.perf_counter() - t0:.2f} s: "
        f"{len(blocks)} requests; outputs {[o[:60] for o in outputs]}; launches {launches}")
    assert len(blocks) == len(e2e_generation.DEFAULT_PROMPTS) and "finished 4 requests" in text
    assert all(o.split() and set(o.split()) <= set(table) for o in outputs), outputs
    _require("text", launches, ran=("elementwise", "w4a8_gemm_per_chn", "flash_prefill_attention",
                                    "paged_decode_attention", "kv_append", "sample_filtered"))
    return launches, dict(requests=len(blocks), outputs=outputs)


def phase_checkpoint(dev, engine_a, streams_a):
    """Checkpoints on the card, after path a:
    1. path a's params (Llama-3-8B w4a8kv4 per-channel, bf16 head, 32
       layers) saved as a packed checkpoint and served again through
       EngineArgs(model, quant_path): every leaf bit for bit, path a's
       streams token for token, path a's kernels launched;
    2. the loaded engine rebuilt with benchmarking=True: path a's requests
       with the sampled ids fed back on the card, their chain equal to
       path a's greedy streams, no wait for the card in a decode step
       (sync debug mode); then the decode step's host ms, CUDA-event span
       and busy share with and without the feed, interleaved;
    3. an HF directory of bf16 weights at Llama-3-8B widths, 2 layers, in
       two safetensors shards, quantized at load on the card: equal bit for
       bit to quantize_params on the CPU, then serving token-id requests;
       where transformers and tokenizers are installed, e2e_generation's
       main() then serves text from it with a tokenizer built here.
    Returns ({path: launches}, summary)."""
    import os
    import shutil

    import torch

    from qserve_tpu_torch.convert import checkpoint_converter as cc
    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.models import llama, loader
    from qserve_tpu_torch.sampling_params import SamplingParams
    from qserve_tpu_torch.utils.weight_utils import write_safetensors

    launches, summary, dirs = {}, {}, []
    runner_a = engine_a.worker.model_runner
    params_a, args_a = runner_a.params, runner_a.model_args
    try:
        # 1. packed: save, load, bits, streams
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params_a))
        d = _ckpt_dir("packed", nbytes)
        dirs.append(d)
        _write_config(d, LLAMA3_8B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = cc.save_packed_checkpoint(params_a, args_a, d)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = cc.load_packed_checkpoint(d, args_a, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"  packed: {written / 1e9:.3f} GB saved in {save_s:.2f} s "
            f"({written / 1e9 / save_s:.2f} GB/s: card to host to file, no fsync), loaded "
            f"in {load_s:.2f} s ({written / 1e9 / load_s:.2f} GB/s: file to card)")
        compared = _same_bits("packed", loaded, params_a)
        del loaded
        engine, build_s = _ckpt_engine(dev, d, quant_path=d)
        compared = _same_bits("packed engine", engine.worker.model_runner.params, params_a)
        log(f"  packed: {compared / 1e9:.3f} GB of weights equal to path a's bit for bit, "
            f"loaded alone and in an engine built in {build_s:.2f} s (its tokenizer lookup "
            f"included; transformers here: {_has('transformers')}, safetensors: "
            f"{_has('safetensors')}, tokenizers: {_has('tokenizers')})")
        launches["ckpt"], summary["packed_path_a"], streams = _path_a(engine, "packed path a")
        same = {r: streams[r] == streams_a[r] for r in streams_a}
        log(f"  packed path a: streams equal to path a's: {same}")
        assert all(same[r] for r in PATH_A_GREEDY), "packed: greedy streams differ from path a's"
        summary.update(save_gb_s=written / 1e9 / save_s, load_gb_s=written / 1e9 / load_s,
                       packed_gb=written / 1e9, save_s=save_s, load_s=load_s,
                       engine_build_s=build_s,
                       sampled_streams_equal=all(same.values()))
        del engine
        _release()

        # 2. device feed from the same checkpoint
        engine, _ = _ckpt_engine(dev, d, quant_path=d, benchmarking=True)
        runner = engine.worker.model_runner
        assert runner.benchmarking
        watch = _DecodeWatch(runner)
        want, _ = _add_path_a(engine)
        _build.reset_launch_counts()
        r = _drive(engine, want)
        launches["feed"] = dict(_build.LAUNCHES)
        _require_path_a("device-fed path a", launches["feed"])
        chain = _chain(engine, watch.steps, r["streams"])
        same = {rid: chain[rid] == streams_a[rid] for rid in streams_a}
        log(f"  device feed: {len(watch.steps)} decode steps; chains equal to path a's "
            f"streams: {same}; waits for the card in its decode steps: {watch.waits}")
        assert all(same[rid] for rid in PATH_A_GREEDY), "device feed: greedy chains differ"
        assert not watch.waits, f"a device-fed decode step waited for the card: {watch.waits}"
        # the same engine with the feed off: its decode steps' waits
        runner.benchmarking = False
        _drive(engine, _add_path_a(engine, "w")[0])
        waits_normal = sorted(set(watch.waits))
        log(f"  without the feed, decode steps wait for the card at: {waits_normal}")
        watch.close()
        # interleaved: off, on, on, off; then one profiled round of each
        rounds = {False: [], True: []}
        for i, feed in enumerate((False, True, True, False)):
            runner.benchmarking = feed
            rounds[feed].append(_decode_round(engine, f"t{i}"))
        busy = {}
        for feed in (False, True):
            runner.benchmarking = feed
            p = _decode_round(engine, f"p{int(feed)}", profile=True)
            busy[feed] = p
        for feed in (False, True):
            host = [x for rr in rounds[feed] for x in rr["host_ms"]]
            ev = [x for rr in rounds[feed] for x in rr["event_ms"]]
            name = "device feed" if feed else "ids read back"
            b = busy[feed]
            log(f"  decode steps, {name}: {len(host)} steps in 2 rounds; host ms median "
                f"{statistics.median(host):.3f} (min {min(host):.3f}, max {max(host):.3f}); "
                f"CUDA-event span median {statistics.median(ev):.3f} ms; rounds "
                f"{[round(rr['run_s'], 3) for rr in rounds[feed]]} s; card busy "
                f"{b['busy_ms']:.1f} of {b['wall_ms']:.1f} ms over 30 profiled decode steps "
                f"({100 * b['busy_ms'] / b['wall_ms']:.1f}%)")
            summary[f"decode_{'feed' if feed else 'readback'}"] = dict(
                host_ms_median=statistics.median(host), event_ms_median=statistics.median(ev),
                round_s=[rr["run_s"] for rr in rounds[feed]],
                busy_ms=b["busy_ms"], wall_ms=b["wall_ms"],
                busy_share=b["busy_ms"] / b["wall_ms"])
        summary["waits_readback"] = waits_normal
        del engine, runner, watch
        _release()

        # 3. HF directory, self-quantized on the card
        hf_cfg = dict(LLAMA3_8B, num_hidden_layers=2)
        args = loader.args_from_config_dict(hf_cfg, args_a.quant)
        E, I, V = args.hidden_size, args.intermediate_size, args.vocab_size
        shapes = {"self_attn.q_proj": (args.q_size, E), "self_attn.k_proj": (args.kv_size, E),
                  "self_attn.v_proj": (args.kv_size, E), "self_attn.o_proj": (E, args.q_size),
                  "mlp.gate_proj": (I, E), "mlp.up_proj": (I, E), "mlp.down_proj": (E, I)}
        hf_bytes = 2 * (2 * V * E + 2 * sum(a * b for a, b in shapes.values()))
        h = _ckpt_dir("hf", hf_bytes)
        dirs.append(h)
        _write_config(h, hf_cfg)
        g = torch.Generator(device=dev).manual_seed(7)

        def rnd(*shape, scale=0.02, base=0.0):
            return (base + scale * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

        t0 = time.perf_counter()
        for li, names in ((0, ("model.embed_tokens.weight",)), (1, ("lm_head.weight", "model.norm.weight"))):
            shard = {}
            for n in names:
                shard[n] = rnd(E, scale=0.1, base=1.0) if n == "model.norm.weight" else rnd(V, E)
            p = f"model.layers.{li}"
            shard[f"{p}.input_layernorm.weight"] = rnd(E, scale=0.1, base=1.0)
            shard[f"{p}.post_attention_layernorm.weight"] = rnd(E, scale=0.1, base=1.0)
            for n, shape in shapes.items():
                shard[f"{p}.{n}.weight"] = rnd(*shape)
            write_safetensors(shard, os.path.join(h, f"model-0000{li + 1}-of-00002.safetensors"))
            del shard
        write_s = time.perf_counter() - t0
        engine, hf_s = _ckpt_engine(dev, h)
        log(f"  hf: {hf_bytes / 1e9:.3f} GB of bf16 in two shards written in {write_s:.2f} s; "
            f"engine built (read, quantized on the card) in {hf_s:.2f} s")
        t0 = time.perf_counter()
        cpu = llama.quantize_params(loader.load_float_params_from_hf(h, args), args, device="cpu")
        cpu_s = time.perf_counter() - t0
        compared = _same_bits("hf", engine.worker.model_runner.params, cpu)
        log(f"  hf: {compared / 1e9:.3f} GB of quantized weights equal bit for bit to "
            f"quantize_params on the CPU ({cpu_s:.1f} s there)")
        del cpu
        rng = np.random.default_rng(9)
        want = {}
        for i in range(4):
            want[f"hf{i}"] = 16
            engine.add_request(f"hf{i}", prompt_token_ids=rng.integers(0, V, 200 + 50 * i).tolist(),
                               sampling_params=SamplingParams(max_tokens=16, ignore_eos=True,
                                                              temperature=0.0))
        _build.reset_launch_counts()
        r = _drive(engine, want)
        launches["hf"] = dict(_build.LAUNCHES)
        _require_path_a("hf (2 layers)", launches["hf"])
        log(f"  hf: {r['finished']} requests served, {r['tokens_out']} tokens; launches "
            f"{launches['hf']}")
        summary.update(hf_gb=hf_bytes / 1e9, hf_write_s=write_s, hf_engine_s=hf_s,
                       hf_cpu_quantize_s=cpu_s)
        del engine
        _release()
        if _has("transformers") and _has("tokenizers"):
            launches["text"], summary["text"] = _text_on_card(h, V)
        else:
            log("  text: not run on the card: transformers or tokenizers is not installed "
                "here (tests/test_torch_checkpoint.py holds the text path on the CPU)")
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return launches, summary


def phase_refusal(dev):
    """What is still unported raises; nothing else runs in its place."""
    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    try:
        EngineArgs(hf_config=LLAMA3_8B, random_weights=True, device=dev,
                   tensor_parallel_size=2).build_engine()
    except NotImplementedError as e:
        assert "ROADMAP" in str(e)
        log(f"  tensor_parallel_size=2 refused: {e}")
    else:
        raise AssertionError("a tensor-parallel engine was built without its port")


def build_report():
    """Builds every CUDA source, prints what ptxas reported for each, and
    counts the tensor-core instructions (HMMA / IMMA: bf16 / int8 mma.sync,
    HGMMA / IGMMA: wgmma) in the SASS of the two prefill attention libraries,
    which must have some, and of the three GEMM libraries, which must have
    int8 wgmma and no mma.sync: one wgmma loop serves K2, K8 and K9."""
    import os
    import shutil

    from qserve_tpu_torch.kernels import _build

    t = time.perf_counter()
    targets = _build.build_all()
    log(f"build: {len(targets)} CUDA sources in {time.perf_counter() - t:.1f} s")
    for stem, so in targets.items():  # ptxas: registers, shared memory, spills
        with open(so[:-3] + ".log") as f:
            for line in f:
                spill = "spill" in line and "0 bytes spill stores, 0" not in line
                if "Used" in line or "entry function" in line or spill:
                    log(f"  {stem}: {line.strip()}")
                # K4 is held to no spill at any (D, bits, rep) instance
                assert not (spill and stem == "paged_attention"), \
                    f"paged_attention spills: {line.strip()}"
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    gemms = ("w4a8_gemm", "w4a8_gemm_per_group", "w8a8_gemm")
    for stem in ("flash_attention", "prefix_attention") + gemms:
        sass = subprocess.run([cuobjdump, "-sass", targets[stem]], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        n = {op: sum(f" {op}." in line or f" {op} " in line for line in sass.splitlines())
             for op in ("HMMA", "HGMMA", "IMMA", "IGMMA")}
        log(f"  {stem} SASS: " + ", ".join(f"{v} {k}" for k, v in n.items())
            + " instructions")
        if stem in gemms:  # s8 wgmma shows as IGMMA, s8 mma.sync as IMMA
            assert n["IGMMA"] > 0, f"{stem}: no int8 wgmma instruction in its SASS"
            assert n["IMMA"] == 0, f"{stem}: an int8 mma.sync loop is left in its SASS"
        else:
            assert n["HMMA"] + n["HGMMA"] > 0, \
                f"{stem}: no tensor-core instruction in its SASS"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from qserve_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")

    build_report()

    res = Results()
    kernel_phases = dict(
        elementwise=phase_elementwise, gemm=phase_gemm, gemm_routed=phase_gemm_routed,
        flash=phase_flash,
        paged=phase_paged, kv_append=phase_kv_append, prefix=phase_prefix,
        sampler=phase_sampler)
    for name, fn in kernel_phases.items():
        t = time.perf_counter()
        log(f"phase {name}")
        fn(res, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"  phase {name} ok in {time.perf_counter() - t:.1f} s")
    log("phase reference")
    for spec in (("w4a8kv4", -1, 16), ("w4a8kv4", 128, 16), ("w4a8kv8", 128, 8),
                 ("w8a8kv8", -1, 8), ("w16a16kv8", -1, 16)):
        phase_reference(dev, *spec)
    for spec in (("w4a8kv4", -1), ("w4a8kv4", 128), ("w8a8kv8", -1), ("w16a16kv8", -1)):
        phase_reference(dev, *spec, moe=True)
    log("phase engine")
    t = time.perf_counter()
    launches, summary = phase_engine(dev)
    log(f"  phase engine ok in {time.perf_counter() - t:.1f} s")
    log("phase refusal")
    phase_refusal(dev)
    log(f"kernel rows: {json.dumps(res.all)}")
    log(f"engine summary: {json.dumps(summary)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    # every kernel ran on some path, counted from 0 at that path's start
    idle = [k for k in ROUTES if not any(l.get(k, 0) for l in launches.values())]
    assert not idle, f"kernels launched on no path: {idle}"
    kernels = []
    for name, (route, source, replaces) in ROUTES.items():
        r = res.rows[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(l.get(name, 0) for l in launches.values()),
            launches_by_path={k: l.get(name, 0) for k, l in launches.items()},
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
            dev_ms=r.get("dev_ms"),
        ))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
