#!/usr/bin/env python3
"""Times K1 (qserve_tpu_torch/kernels/csrc/elementwise.cu, the fused
norm/SiLU/quant pass) and K7 (csrc/sampler.cu, the filtered sampler) as
committed beside another checkout's, on one NVIDIA GPU, or the engine steps
they carry. From the repo root:

    python3 scripts/ab_elementwise_sampler.py [--parent DIR] [--rounds N]
    python3 scripts/ab_elementwise_sampler.py --steps [--tree DIR]

Kernel mode: each (kernel, shape, tree) is timed in one process, over
rounds in alternating order (parent, change, change, parent, ...), two
ways: device time, CUDA events around 20 back-to-back calls captured in a
CUDA graph and replayed (a call's host time, ~30 us, exceeds the device
time of most shapes: back-to-back calls from Python would time the host),
and host time a call, `perf_counter` over 200 calls without a sync (what
the Python wrapper and the launch cost the host). Calls go through each tree's wrapper: the change's
`elementwise.launch` and `sampler.sample_filtered`; the parent's K1 through
DIR's own `kernels/elementwise.py` and its Triton kernel
(`kernels/elementwise_triton.py`, imported from DIR), the parent's K7
through DIR's `csrc/sampler.cu`, built with the committed nvcc flags and
called with its own C signature (no cluster arguments) behind a
`torch.empty` of its output, as its wrapper did. K1 at T in {1, 8, 64,
2048} x each mode x W in {4096, 11008, 14336}; K7 at B in {1, 8, 16, 64} x
V in {32000, 128256} with chip_smoke.py's row kinds (greedy, temperature,
top-k 50, top-p 0.9, both, top-k 1, ties). Beside them, the alternatives
the host's choices weighed: K1 at T = 2048 and 64 at every other block
shape that fills the row as tightly as `launch_shape`'s, and K7 with the
other thread count and with the source VARIANTS below. Each change's output is compared
with the parent's: K1's codes within 1 (count reported), K7's tokens under
one noise operand and under the kernels' own generator at one (seed,
offset) (differing tokens reported).

Steps mode: the engines of the tree at DIR (default: this one) at full
width and depth, random weights: Llama-3-8B W4A8KV4 per-channel serving
chip_smoke.py's path a traffic (8 prompts of 128-1024 tokens, 32 out; the
first prefill carries first-use costs: read the second), then
Mixtral-8x7B W4A8KV4 per-channel prefilling two 2000-token prompts and
decoding 4 tokens (the masked expert loop); each step's host clock and its
CUDA-event device time. Run it once per tree in one call to compare them.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import statistics
import sys
import tempfile

from ab_common import CSRC, build, host_ms, smi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"quant": 0, "rmsnorm_quant": 1, "add_rmsnorm_quant": 2, "silu_mul_quant": 3}

# source variants of the change's K7, timed beside it through the same C
# entry (their draws are checked against the change's)
VARIANTS = {
    "8 probes": [("constexpr int PROBES = 4;", "constexpr int PROBES = 8;")],
}


def k1_shapes(W, f32, few):
    """Every (threads, vpt) the kernel takes that fills a one-chunk row of W
    as tightly as launch_shape's pick: the alternatives its rule weighed."""
    from qserve_tpu_torch.kernels import elementwise as ew

    pick = ew.launch_shape(W, f32, few)
    nv = -(-W // ew.VEC)
    idle = pick.threads * pick.vpt - nv
    out = []
    for vpt in range(1, (ew.MAX_VPT_F32 if f32 else ew.MAX_VPT) + 1):
        threads = 32 * -(-nv // (32 * vpt))
        if threads <= ew.MAX_THREADS and threads * vpt - nv <= idle:
            out.append((threads, vpt))
    return out


def k1_direct(mode, x, d, w, threads, vpt):
    """The change's K1 C entry at another block shape (a one-chunk row)."""
    import torch

    from qserve_tpu_torch.kernels import _build, elementwise as ew

    T = x.shape[0]
    W = x.shape[1] // 2 if mode == 3 else x.shape[1]
    h = torch.empty_like(x) if mode == 2 else None
    q = torch.empty((T, W), dtype=torch.int8, device=x.device)
    sums = torch.empty((2, T), dtype=torch.float32, device=x.device)
    fn = _build.function("elementwise", "qs_fused_quant", ew._ARGS)
    rc = fn(mode, x.data_ptr(), d.data_ptr() if d is not None else None,
            w.data_ptr() if w is not None else None,
            h.data_ptr() if h is not None else None, q.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), T, W, 1e-5, threads, vpt, 1, _build.stream())
    assert rc == 0, rc
    return q


def k7_direct(fn, s, k, p, noise=None, split=None):
    """A K7 library with the change's C signature, at the wrapper's cluster
    split or another."""
    import torch

    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.kernels import sampler as ksampler

    B, V = s.shape
    split = split or ksampler.cluster_split(V)
    o = torch.empty((B,), dtype=torch.int32, device=s.device)
    rc = fn(s.data_ptr(), k.data_ptr(), p.data_ptr(),
            noise.data_ptr() if noise is not None else None, 3, 1, o.data_ptr(), B, V,
            split.cluster, split.slice, split.threads, 1, 1, _build.stream())
    assert rc == 0, rc
    return o


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def parent_k1(parent):
    """DIR's K1 wrapper, running DIR's Triton kernel: its elementwise.py
    imports `qserve_tpu_torch.kernels.elementwise_triton`, which here
    resolves to DIR's file."""
    import qserve_tpu_torch.kernels as pkg

    kdir = os.path.join(parent, "qserve_tpu_torch", "kernels")
    pkg.elementwise_triton = _load("qserve_tpu_torch.kernels.elementwise_triton",
                                   os.path.join(kdir, "elementwise_triton.py"))
    return _load("parent_elementwise", os.path.join(kdir, "elementwise.py")).launch


def k1_cases(dev):
    """(tag, mode, x, delta, weight) at every (T, mode, W)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for T in (1, 8, 64, 2048):
        for name, mode in MODES.items():
            for W in (4096, 11008, 14336):
                width = 2 * W if mode == 3 else W
                x = (2 * torch.randn(T, width, generator=g, device=dev)).to(torch.bfloat16)
                d = (torch.randn(T, W, generator=g, device=dev).to(torch.bfloat16)
                     if mode == 2 else None)
                w = 1 + 0.1 * torch.randn(W, generator=g, device=dev) if mode in (1, 2) else None
                cases.append((f"{name} T={T} W={W}", mode, x, d, w))
    return cases


def k7_cases(dev):
    """(tag, scaled, k_eff, p_t, noise) at every (B, V)."""
    import torch

    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for B in (1, 8, 16, 64):
        for V in (32000, 128256):
            logits, temp, top_p, top_k, _ = chip_smoke.sampler_rows(dev, g, B, V)
            _, _, k_eff, p_t = chip_smoke.sampler_operands(dev, temp, top_p, top_k, V)
            scaled = logits / temp.clamp(min=1e-6).to(dev)[:, None]
            noise = -torch.log(-torch.log(
                torch.rand(B, V, generator=g, device=dev).clamp(min=2.0**-24)))
            cases.append((f"B={B} V={V}", scaled, k_eff, p_t, noise))
    return cases


def kernels(opts):
    import torch

    import chip_smoke

    from qserve_tpu_torch.kernels import _build, elementwise
    from qserve_tpu_torch.kernels import sampler as ksampler

    dev = "cuda"
    _build.build_all()
    calls = {}  # (kernel, tag, tree or variant) -> call
    k1 = k1_cases(dev)
    k7 = k7_cases(dev)
    for tag, mode, x, d, w in k1:
        calls[("K1", tag, "change")] = (
            lambda mode=mode, x=x, d=d, w=w: elementwise.launch(mode, x, d, w, 1e-5))
    for tag, mode, x, d, w in k1:
        if not (tag.startswith(("add_rmsnorm_quant", "quant", "silu_mul_quant"))
                and (" T=2048 " in tag or " T=64 " in tag)):
            continue
        W = x.shape[1] // 2 if mode == 3 else x.shape[1]
        few = x.shape[0] < elementwise.FEW_ROWS
        pick = elementwise.launch_shape(W, mode == 3, few)
        for threads, vpt in k1_shapes(W, mode == 3, few):
            if (threads, vpt) != (pick.threads, pick.vpt):
                calls[("K1", tag, f"{threads}x{vpt}")] = (
                    lambda mode=mode, x=x, d=d, w=w, t=threads, v=vpt:
                    k1_direct(mode, x, d, w, t, v))
    for tag, scaled, k_eff, p_t, _ in k7:
        calls[("K7", tag, "change")] = (
            lambda s=scaled, k=k_eff, p=p_t: ksampler.sample_filtered(
                s, k, p, True, True, seed=3, offset=1))
    with tempfile.TemporaryDirectory() as tmp:
        here = os.path.join(ROOT, CSRC)
        started = {name: build(tmp, f"v{i}-sampler", here, "sampler", edits)
                   for i, (name, edits) in enumerate(VARIANTS.items())}
        fc = _build.function("sampler", "qs_sample_filtered", ksampler._ARGS)
        for name, (so, proc) in started.items():  # all nvcc at once
            out = proc.communicate()[0]
            assert proc.returncode == 0, f"{name}: nvcc failed\n{out}"
            fv = getattr(ctypes.CDLL(so), "qs_sample_filtered")
            fv.argtypes, fv.restype = ksampler._ARGS, ctypes.c_int
            for tag, scaled, k_eff, p_t, noise in k7:
                got = k7_direct(fv, scaled, k_eff, p_t, noise)
                want = k7_direct(fc, scaled, k_eff, p_t, noise)
                assert torch.equal(got, want), (name, tag)
                calls[("K7", tag, name)] = (
                    lambda f=fv, s=scaled, k=k_eff, p=p_t: k7_direct(f, s, k, p))
        for tag, scaled, k_eff, p_t, _ in k7:
            pick = ksampler.cluster_split(scaled.shape[1])
            other = pick._replace(threads=768 - pick.threads)
            calls[("K7", tag, f"{other.threads} threads")] = (
                lambda s=scaled, k=k_eff, p=p_t, sp=other: k7_direct(fc, s, k, p, split=sp))
        if opts.parent:
            launch_p = parent_k1(opts.parent)
            so, proc = build(tmp, "parent-sampler", os.path.join(opts.parent, CSRC),
                             "sampler")
            out = proc.communicate()[0]
            assert proc.returncode == 0, f"parent sampler: nvcc failed\n{out}"
            fp = getattr(ctypes.CDLL(so), "qs_sample_filtered")
            P, I, U64 = _build.P, _build.I, ctypes.c_uint64
            fp.argtypes, fp.restype = [P] * 4 + [U64, U64, P] + [I] * 4 + [P], ctypes.c_int

            def parent_k7(s, k, p, noise=None, seed=3, offset=1):
                B, V = s.shape
                o = torch.empty((B,), dtype=torch.int32, device=s.device)
                rc = fp(s.data_ptr(), k.data_ptr(), p.data_ptr(),
                        noise.data_ptr() if noise is not None else None, seed, offset,
                        o.data_ptr(), B, V, 1, 1, _build.stream())
                assert rc == 0, rc
                return o

            for tag, mode, x, d, w in k1:
                calls[("K1", tag, "parent")] = (
                    lambda mode=mode, x=x, d=d, w=w: launch_p(mode, x, d, w, 1e-5))
            for tag, scaled, k_eff, p_t, noise in k7:
                calls[("K7", tag, "parent")] = (
                    lambda s=scaled, k=k_eff, p=p_t: parent_k7(s, k, p))
                got = ksampler.sample_filtered(scaled, k_eff, p_t, True, True, noise=noise)
                want = parent_k7(scaled, k_eff, p_t, noise)
                own = ksampler.sample_filtered(scaled, k_eff, p_t, True, True, seed=3,
                                               offset=1)
                print(f"K7 {tag}: {int((got != want).sum())} of {len(got)} tokens differ "
                      "from the parent's under one noise operand, "
                      f"{int((own != parent_k7(scaled, k_eff, p_t)).sum())} under the "
                      "kernels' own generator", flush=True)
            for tag, mode, x, d, w in k1:
                got = elementwise.launch(mode, x, d, w, 1e-5)
                want = launch_p(mode, x, d, w, 1e-5)
                dq = (got[1].int() - want[1].int()).abs()
                same_h = got[0] is None or torch.equal(got[0], want[0])
                print(f"K1 {tag}: codes off by at most {int(dq.max())}, "
                      f"{int((dq > 0).sum())} of {dq.numel()} differ; h equal {same_h}",
                      flush=True)
                assert int(dq.max()) <= 1 and same_h, tag
        times = {key: ([], []) for key in calls}
        keys = list(calls)
        for r in range(opts.rounds):  # parent, change, change, parent, ...
            for key in (keys if r % 2 else keys[::-1]):
                times[key][0].append(chip_smoke.device_ms(calls[key]))
                times[key][1].append(host_ms(calls[key]))
    print(smi())
    for (kernel, tag, tree), (dv, hs) in times.items():
        print(f"{kernel} {tag:32s} {tree:7s} device {statistics.median(dv):.4g} ms "
              f"(min {min(dv):.4g}, max {max(dv):.4g})  host {statistics.median(hs):.4g} "
              f"ms a call (min {min(hs):.4g}, max {max(hs):.4g}); median of {len(dv)} "
              "rounds", flush=True)
    return 0


def steps(opts):
    tree = os.path.abspath(opts.tree or ROOT)
    sys.path.insert(0, tree)
    import numpy as np

    import chip_smoke  # the tree's: only its model configs are read
    from ab_decode_gemm import run_steps

    print(f"steps of {tree} on {smi()}", flush=True)
    lens = np.random.default_rng(0).integers(128, 1025, 8)  # chip_smoke path a
    pc = dict(precision="w4a8kv4", group_size=-1)
    run_steps("llama3-8b w4a8kv4", chip_smoke.LLAMA3_8B, lens, 32, **pc)
    run_steps("mixtral-8x7b w4a8kv4", chip_smoke.MIXTRAL_8X7B, [2000, 2000], 4, **pc)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout whose K1 and K7 to time beside these")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", action="store_true", help="time engine steps instead")
    ap.add_argument("--tree", help="steps mode: the checkout whose engine to run")
    opts = ap.parse_args()
    if opts.steps:
        return steps(opts)
    sys.path.insert(0, ROOT)
    return kernels(opts)


if __name__ == "__main__":
    sys.exit(main())
