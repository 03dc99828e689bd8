#!/usr/bin/env python3
"""Times one MoE layer's expert FFN (models/llama.py `_moe_mlp`: router,
top-k, experts, combine) as the masked loop over every expert and as the
routed dispatch's broadcast stream, on one NVIDIA GPU, at the benchmark
cells' decode shapes (chip_smoke.MOE_DECODE_CASES: Mixtral-8x7B at T = 16
and 128 rows, Mellum2-12B-A2.5B at T = 32). From the repo root:

    python3 scripts/ab_moe_dispatch.py [--rounds N]

One process, W4A8 per-channel random weights (chip_smoke.moe_layer, one
layer at published widths). Each case first holds the broadcast output to
the masked loop's bit for bit. Then, over rounds in alternating order, it
times by 20 calls captured in a CUDA graph and replayed
(chip_smoke.device_ms, as the decode graphs replay them):

  * the whole FFN, masked and broadcast;
  * the GEMMs alone: the masked loop's NE dense K2 gate_up and NE down at
    M = T (one launch an expert), and the broadcast stream's routed K2
    (K10) gate_up and down over NE blocks of T rows padded to 128.

Beside them: the port launches and the device operations (torch.profiler)
of one call of each dispatch, and the layer's byte bound, every expert's
weights read once at 3.35 TB/s (all experts are live at these shapes: T k
picks over NE), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BPS = 3.35e12


def _device_kernels(fn):
    """The device operations (kernels, copies, fills) of one call, by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def case(model, T, rounds):
    import torch

    import chip_smoke as cs
    from qserve_tpu_torch.kernels import _build, ops
    from qserve_tpu_torch.models import llama

    dev = "cuda"
    args, (gu, down), norm, ffn = cs.moe_layer(dev, model)
    E, I, NE, k = args.hidden_size, args.intermediate_size, args.num_experts, args.moe_top_k
    g = torch.Generator(device=dev).manual_seed(T)
    x = norm(torch.randn(T, E, generator=g, device=dev))
    want = ffn(x, masked=True)
    assert torch.equal(ffn(x), want), f"{model} T={T}: broadcast differs from the masked loop"
    _, P = llama.moe_stream(T, k, NE, args.moe_route_block)
    Tp = P // NE
    be = torch.arange(NE, dtype=torch.int32, device=dev)

    def acts(K, rows):
        return (torch.randint(-128, 128, (rows, K), generator=g, device=dev, dtype=torch.int8),
                torch.rand(rows, 1, generator=g, device=dev) * 0.05,
                torch.randn(rows, 1, generator=g, device=dev))

    a_gu, a_dn = acts(E, P), acts(I, P)
    fns = {
        "ffn masked": lambda: ffn(x, masked=True),
        "ffn broadcast": lambda: ffn(x),
        "gate_up masked (NE x K2)": lambda: [ops.w4a8_gemm_per_chn(
            *(a[:T] for a in a_gu), *(w[e] for w in gu)) for e in range(NE)],
        "gate_up broadcast (K10)": lambda: ops.w4a8_gemm_per_chn_routed(*a_gu, *gu, be),
        "down masked (NE x K2)": lambda: [ops.w4a8_gemm_per_chn(
            *(a[:T] for a in a_dn), *(w[e] for w in down)) for e in range(NE)],
        "down broadcast (K10)": lambda: ops.w4a8_gemm_per_chn_routed(*a_dn, *down, be),
    }
    ms = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ms[name].append(cs.device_ms(fns[name]))
    w_gu = NE * (E * 2 * I // 2 + 8 * 2 * I)  # packed nibbles, s1 scale and zero
    w_dn = NE * (I * E // 2 + 8 * E)
    bounds = {"ffn": (w_gu + w_dn + 4 * E * NE) / HBM_BPS * 1e3,
              "gate_up": w_gu / HBM_BPS * 1e3, "down": w_dn / HBM_BPS * 1e3}
    tag = f"{model} T={T} (top-{k} of {NE}, broadcast stream {NE} x {Tp} rows)"
    print(f"{tag}: broadcast == masked loop bit for bit", flush=True)
    for masked in (True, False):
        before = dict(_build.LAUNCHES)
        ffn(x, masked)
        port = sum(v - before.get(n, 0) for n, v in _build.LAUNCHES.items())
        ops_n = _device_kernels(lambda: ffn(x, masked))
        print(f"  {'masked' if masked else 'broadcast'}: {port} port launches a call, "
              f"{ops_n} device operations ({ops_n - port} of them ATen kernels, copies "
              f"and fills)", flush=True)
    for name, v in ms.items():
        b = bounds[name.split()[0]]
        med = statistics.median(v)
        print(f"  {name}: {med:.4g} ms (rounds {', '.join(f'{t:.4g}' for t in v)}; "
              f"byte bound {b:.4g} ms, {100 * b / med:.1f}%)", flush=True)
    return {name: statistics.median(v) for name, v in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from ab_common import smi
    from qserve_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("ab_moe_dispatch: no CUDA device", file=sys.stderr)
        return 2
    print(f"{smi()}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.build_all()
    for model, T in cs.MOE_DECODE_CASES:
        case(model, T, opts.rounds)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
