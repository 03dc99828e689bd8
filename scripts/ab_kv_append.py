#!/usr/bin/env python3
"""Times K5 (qserve_tpu_torch/kernels/csrc/kv_append.cu, the fused KV
quantize-and-append) beside another checkout's KV append, on one NVIDIA GPU,
or the engine steps it carries. From the repo root:

    python3 scripts/ab_kv_append.py [--parent DIR] [--rounds N]
    python3 scripts/ab_kv_append.py --steps [--tree DIR | --alternate DIR]

Kernel mode: every (case, tree) is timed in one process, over rounds in
alternating order (parent, change, change, parent, ...), two ways: device
time, CUDA events around 20 back-to-back calls captured in a CUDA graph and
replayed, and host time a call, `perf_counter` over 200 calls without a
sync (decode shapes only: at prefill the plain quantize's device time
fills the launch queue and the host waits on it). The change is
`kv_append.kv_append` (one launch); the parent is DIR's pipeline as its
`kv_cache.append_all_layers` ran it on the card: DIR's `_quantize_rows`
(loaded from DIR; ~50 PyTorch calls), the cast of the scales, then DIR's
row-scatter kernel (`csrc/kv_append.cu` `qs_kv_append`, built with the
committed nvcc flags and called with its own C signature). Both start from
the same cache and must leave the same bytes. Beside them, the change's C
entry at the other tokens-a-block counts `launch_shape` weighed, and the
source VARIANTS below (built at once, each held to the change's bytes). Cases:
chip_smoke.py's (Llama-3-8B prefill T = 2048 and decode T = 64 at KV4,
KV8 decode, Llama-2-7B's 32 kv heads at KV8 prefill and decode, the mixed
step's strided chunk view), 32 layers, pages of 256.

Steps mode: the engines of the tree at DIR (default: this one) at full
width and depth, random weights, chip_smoke.py's traffic: Llama-3-8B
W4A8KV4 per-channel serving path a (8 prompts of 128-1024 tokens, 32 out:
prefill and decode steps) and then path b's long prompt (6000 tokens
admitted in mixed steps beside 7 decoding requests), and Llama-2-7B W4A8KV8
g128 serving path d (6 requests decode, a 3000-token prompt admits in mixed
steps, a 2500-token prompt alone: prefill and chunk); each step kind's host
clock, CUDA-event device time and peak allocated memory. Run it once per
tree in one call, in the order parent, change, change, parent. With
`--alternate DIR` it runs this tree's engines once and swaps the KV append
for DIR's pipeline (as kernel mode builds it) on every other step: the two
appends leave the same bytes, so the traffic is the same, and decode steps,
whose host clocks spread by milliseconds between runs, compare within one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import statistics
import sys
import tempfile
import time

from ab_common import CSRC, build, host_ms, smi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 256

# source variants of the change's kernel, timed beside it through the same
# C entry at the wrapper's (lanes, tb); each must leave the change's bytes
VARIANTS = {
    "IEEE quotient every value": [(
        "  float r = rintf(p);\n  if (fabsf(p - r) > 0.4999f) r = rintf(__fdiv_rn(d, q.scale));",
        "  float r = rintf(__fdiv_rn(d, q.scale));")],
    "U=4": [("constexpr int U = 2;", "constexpr int U = 4;")],
    "128 threads": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(dev):
    """(tag, cache, k, v, pages, slots, kv_bits) at chip_smoke.py's shapes."""
    import torch

    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(5)
    L = chip_smoke.LLAMA3_8B["num_hidden_layers"]
    lens, pages, slots, p0 = [700, 512, 436, 300], [], [], 0
    for n in lens:
        pages += [p0 + i // PS for i in range(n)]
        slots += [i % PS for i in range(n)]
        p0 += -(-n // PS)
    pages += [-1] * (2048 - len(pages))
    slots += [0] * (2048 - len(slots))
    d_pages, d_slots = list(range(3, 67)), list(range(64))
    out = []
    for tag, H, pg, sl, bits, extra in (
            ("8B prefill KV4", 8, pages, slots, 4, 0),
            ("8B decode KV4", 8, d_pages, d_slots, 4, 0),
            ("8B decode KV8", 8, d_pages, d_slots, 8, 0),
            ("7B prefill KV8 H=32", 32, pages, slots, 8, 0),
            ("7B decode KV8 H=32", 32, d_pages, d_slots, 8, 0),
            ("8B mixed chunk view KV4", 8, pages, slots, 4, 64)):
        P = p0 + 2 if len(pg) > 64 else 70
        cache, k, v = chip_smoke._append_case(dev, g, L, len(pg), H, 128, PS, P, bits,
                                              extra_rows=extra)
        T = len(pg)
        out.append((tag, cache, k[:, :T], v[:, :T],
                    torch.tensor(pg, dtype=torch.int32, device=dev),
                    torch.tensor(sl, dtype=torch.int32, device=dev), bits))
    return out


def change_direct(fn, cache, k, v, pg, sl, bits, lanes, tb):
    """The change's C entry at a given (lanes, tb)."""
    from qserve_tpu_torch.kernels import _build

    L, P, _, ps, _ = cache.data.shape
    H, D = k.shape[2], k.shape[3]
    rc = fn(k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), cache.data.data_ptr(), cache.scales.data_ptr(), pg.data_ptr(),
            sl.data_ptr(), L, k.shape[1], P, ps, H, D, bits, 1,
            cache.scales.element_size(), lanes, tb, _build.stream())
    assert rc == 0, rc


def parent_append(parent, tmp):
    """DIR's KV append as its `append_all_layers` ran it on the card: its
    plain `_quantize_rows` (loaded from DIR), the cast of the scales, then
    its row-scatter kernel, built from DIR's csrc with the committed nvcc
    flags and called with its own C signature."""
    from qserve_tpu_torch.kernels import _build

    so, proc = build(tmp, "parent-kv_append", os.path.join(parent, CSRC), "kv_append")
    out = proc.communicate()[0]
    assert proc.returncode == 0, f"parent kv_append: nvcc failed\n{out}"
    fp = getattr(ctypes.CDLL(so), "qs_kv_append")
    fp.argtypes = [_build.P] * 6 + [_build.I] * 7 + [_build.P]
    fp.restype = ctypes.c_int
    pk = _load("parent_kv_cache", os.path.join(
        parent, "qserve_tpu_torch", "kernels", "kv_cache.py"))

    def append(cache, k, v, pg, sl, bits, zero_point):
        rows, sc = pk._quantize_rows(k, v, bits, zero_point)
        sc = sc.to(cache.scales.dtype).contiguous()
        L, P, _, ps, hdc = cache.data.shape
        rc = fp(rows.data_ptr(), sc.data_ptr(), cache.data.data_ptr(),
                cache.scales.data_ptr(), pg.data_ptr(), sl.data_ptr(), L,
                rows.shape[1], P, ps, hdc, sc.shape[-1], cache.scales.element_size(),
                _build.stream())
        assert rc == 0, rc
        return cache

    return append


def kernels(opts):
    import torch

    import chip_smoke
    from qserve_tpu_torch.kernels import _build, kv_append, kv_cache as kvc

    dev = "cuda"
    _build.build_all()
    calls, host = {}, set()  # (tag, tree) -> call; keys also timed on the host
    fc = _build.function("kv_append", "qs_kv_quant_append", kv_append._ARGS)
    all_cases = cases(dev)
    with tempfile.TemporaryDirectory() as tmp:
        if opts.parent:
            parent = parent_append(opts.parent, tmp)
        here = os.path.join(ROOT, CSRC)
        started = {name: build(tmp, f"v{i}-kv_append", here, "kv_append", edits)
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        variants = {}
        for name, (so, proc) in started.items():  # all nvcc at once
            out = proc.communicate()[0]
            assert proc.returncode == 0, f"{name}: nvcc failed\n{out}"
            fv = getattr(ctypes.CDLL(so), "qs_kv_quant_append")
            fv.argtypes, fv.restype = kv_append._ARGS, ctypes.c_int
            variants[name] = fv
        for tag, cache, k, v, pg, sl, bits in all_cases:
            args = (cache, k, v, pg, sl, bits)
            pick = kv_append.launch_shape(k.shape[0], k.shape[1], k.shape[2], k.shape[3],
                                          bits, True)
            start = (cache.data.clone(), cache.scales.clone())
            kv_append.kv_append(cache.data, cache.scales, k, v, pg, sl, bits, True)
            want = (cache.data.clone(), cache.scales.clone())
            for name, fv in variants.items():
                cache.data.copy_(start[0])
                cache.scales.copy_(start[1])
                change_direct(fv, *args, pick.lanes, pick.tb)
                torch.cuda.synchronize()
                assert torch.equal(cache.data, want[0]) and torch.equal(
                    cache.scales.view(torch.uint8), want[1].view(torch.uint8)), (name, tag)
                calls[(tag, name)] = (
                    lambda a=args, f=fv, n=pick.lanes, tb=pick.tb: change_direct(f, *a, n, tb))
            del start, want
            decode = k.shape[1] <= 64
            calls[(tag, "change")] = lambda a=args: kv_append.kv_append(
                a[0].data, a[0].scales, *a[1:], True)
            if decode:
                host.add((tag, "change"))
            if opts.parent:
                ref = kvc.KVCache(cache.data.clone(), cache.scales.clone())
                kv_append.kv_append(cache.data, cache.scales, k, v, pg, sl, bits, True)
                parent(ref, k, v, pg, sl, bits, True)
                torch.cuda.synchronize()
                same = (torch.equal(cache.data, ref.data)
                        and torch.equal(cache.scales.view(torch.uint8),
                                        ref.scales.view(torch.uint8)))
                print(f"{tag}: change and parent leave equal bytes: {same}", flush=True)
                assert same, tag
                del ref
                calls[(tag, "parent")] = lambda a=args: parent(*a, True)
                if decode:
                    host.add((tag, "parent"))
            for tb in (1, 2, 4, 8, 16):
                if tb != pick.tb:
                    calls[(tag, f"tb={tb}")] = (
                        lambda a=args, tb=tb, n=pick.lanes: change_direct(fc, *a, n, tb))
        times = {key: ([], []) for key in calls}
        keys = list(calls)
        for r in range(opts.rounds):  # parent, change, change, parent, ...
            for key in (keys if r % 2 else keys[::-1]):
                times[key][0].append(chip_smoke.device_ms(calls[key]))
                if key in host:
                    times[key][1].append(host_ms(calls[key]))
    print(smi())
    for (tag, tree), (dv, hs) in times.items():
        h = (f"host {statistics.median(hs):.4g} ms a call (min {min(hs):.4g}, max "
             f"{max(hs):.4g})" if hs else "host not timed")
        print(f"K5 {tag:26s} {tree:26s} device {statistics.median(dv):.4g} ms (min "
              f"{min(dv):.4g}, max {max(dv):.4g})  {h}; median of {len(dv)} rounds",
              flush=True)
    return 0


def serve(tag, cfg, prompts, max_tokens, arrivals=(), label=None, **engine_kw):
    """Serves `prompts` (token counts, random ids) on a fresh engine of the
    imported tree, adding arrivals [(after_step, prompt_len, max_tokens)];
    prints each step kind's host ms, CUDA-event device ms and peak
    allocated GiB. label(step), where given, runs before each step and
    names the group its times join beside the kind."""
    import gc

    import numpy as np
    import torch

    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams

    t0 = time.perf_counter()
    engine = EngineArgs(hf_config=cfg, random_weights=True, seed=0, device="cuda",
                        block_size=PS, max_num_batched_tokens=2048, max_num_seqs=64,
                        **engine_kw).build_engine()
    print(f"  {tag}: engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)

    def add(name, n, out):
        engine.add_request(name, prompt_token_ids=rng.integers(
            0, cfg["vocab_size"], int(n)).tolist(),
            sampling_params=SamplingParams(max_tokens=out, ignore_eos=True))

    for i, n in enumerate(prompts):
        add(f"{tag}{i}", n, max_tokens)
    pending = sorted(arrivals)
    host, dev, peak, steps = {}, {}, {}, 0
    while engine.has_unfinished_requests() or pending:
        while pending and (pending[0][0] <= steps or not engine.has_unfinished_requests()):
            _, n, out = pending.pop(0)
            add(f"{tag}-late{n}", n, out)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        group = label(steps) if label else ""
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        e0.record()
        engine.step()
        e1.record()
        torch.cuda.synchronize()
        steps += 1
        kind = engine.last_step_kind + group
        host.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        dev.setdefault(kind, []).append(e0.elapsed_time(e1))
        peak.setdefault(kind, []).append(torch.cuda.max_memory_allocated() / 2**30)
    for kind in host:
        print(f"  {tag} {kind}: {len(host[kind])} steps, host ms "
              f"{[round(x, 2) for x in host[kind][:4]]} (median "
              f"{statistics.median(host[kind]):.4g}, min {min(host[kind]):.4g}), device ms "
              f"{[round(x, 2) for x in dev[kind][:4]]} (median "
              f"{statistics.median(dev[kind]):.4g}), peak allocated "
              f"{max(peak[kind]):.3f} GiB", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def steps(opts):
    tree = os.path.abspath(opts.tree or ROOT)
    sys.path.insert(0, tree)
    import numpy as np

    import chip_smoke  # the tree's: only its model configs are read

    label = None
    if opts.alternate:  # this tree's engine, its KV append swapped step by step
        from qserve_tpu_torch.kernels import kv_cache as kvc

        with tempfile.TemporaryDirectory() as tmp:  # the library stays loaded
            impl = {"change": kvc.append_all_layers,
                    "parent": parent_append(opts.alternate, tmp)}
        state = {}
        kvc.append_all_layers = lambda *a: impl[state["now"]](*a)

        def label(step):
            state["now"] = ("parent", "change")[step % 2]
            return f" [{state['now']}]"

    print(f"steps of {tree} on {smi()}" + (
        f", the KV append alternating with {opts.alternate}'s" if label else ""), flush=True)
    lens = np.random.default_rng(0).integers(128, 1025, 8)  # chip_smoke path a
    # path a, then path b's 6000-token prompt beside 7 decoding requests
    serve("llama3-8b w4a8kv4 (paths a, b)", chip_smoke.LLAMA3_8B, lens, 48,
          arrivals=[(8, 6000, 16)], label=label, precision="w4a8kv4", group_size=-1,
          max_model_len=8192, num_device_pages=160)
    d_lens = np.random.default_rng(3).integers(128, 1025, 6)  # chip_smoke path d
    serve("llama2-7b w4a8kv8 g128 (path d)", chip_smoke.LLAMA2_7B, d_lens, 24,
          arrivals=[(4, 3000, 8), (10**9, 2500, 4)], label=label, precision="w4a8kv8",
          group_size=128, max_model_len=4096, num_device_pages=96)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose KV append to time beside this")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", action="store_true", help="time engine steps instead")
    ap.add_argument("--tree", help="steps mode: the checkout whose engine to run")
    ap.add_argument("--alternate", help="steps mode: swap this tree's KV append for "
                    "DIR's pipeline on every other step")
    opts = ap.parse_args()
    if opts.steps:
        return steps(opts)
    sys.path.insert(0, ROOT)
    return kernels(opts)


if __name__ == "__main__":
    sys.exit(main())
