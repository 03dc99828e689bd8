#!/usr/bin/env python3
"""Where a decode step waits for the card, on one H100.

    python3 scripts/decode_waits.py [--tree DIR] [--layers 32] [--alternate]
    python3 scripts/decode_waits.py --copies

Serves chip_smoke.py's path a traffic (Llama-3-8B w4a8kv4 per-channel,
random weights; 8 requests, 6 greedy and 2 at temperature 0.8, 32 tokens
each) twice, with qserve_tpu_torch taken from DIR (another checkout, e.g.
a `git archive` of the parent) or from this one, and lists every
synchronizing CUDA operation a decode step made, as
torch.cuda.set_sync_debug_mode("warn") reports them (source line, count),
beside the decode steps' host ms. A copy from pageable host memory may also
wait for the stream inside the driver, which that mode does not see. Prints
one JSON line.

--alternate (this checkout only) times the decode steps' host ms with the
host inputs copied through pinned staging (utils.to_device, as committed)
and as before it (the runner's `non_blocking` copies from pageable memory,
the sampler's blocking ones), the two swapped round by round in one engine
(pinned, pageable, pageable, pinned, twice), since decode medians of one
tree differ by several ms between processes.

--copies times, on the host clock, ways of moving a decode step's small
host arrays (an int32 [64] and [64, 32]) to the card while the card is
busy (a 20 ms `torch.cuda._sleep` queued first): a copy that waits for the
card takes the rest of that sleep. Median of 20, six copies each.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=None, help="checkout whose qserve_tpu_torch to run")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--alternate", action="store_true")
    p.add_argument("--copies", action="store_true")
    a = p.parse_args()
    if a.copies:
        return _copies()
    tree = os.path.abspath(a.tree or ROOT)
    sys.path.insert(0, tree)
    # this checkout's chip_smoke.py helpers, the tree's package
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from qserve_tpu_torch.engine.arg_utils import EngineArgs

    assert torch.cuda.is_available(), "needs a CUDA device"
    cfg = dict(cs.LLAMA3_8B, num_hidden_layers=a.layers)
    engine = EngineArgs(hf_config=cfg, random_weights=True, device="cuda", block_size=256,
                        max_num_batched_tokens=2048, max_num_seqs=64, max_model_len=8192,
                        num_device_pages=160).build_engine()
    watch = cs._DecodeWatch(engine.worker.model_runner)
    decode_ms = []
    for rnd in range(2):
        want, _ = cs._add_path_a(engine, f"r{rnd}")
        decode_ms += cs._drive(engine, want)["ms"]["decode"]
    waits = collections.Counter(watch.waits)
    if a.alternate:
        watch.close()
        decode_ms = _alternate(cs, engine)
    print(json.dumps(dict(
        tree=tree, package=os.path.dirname(sys.modules["qserve_tpu_torch"].__file__),
        layers=a.layers,
        decode_host_ms_median=(statistics.median(decode_ms) if not a.alternate else
                               {k: statistics.median(v) for k, v in decode_ms.items()}),
        waits={k.replace(tree + "/", ""): v for k, v in waits.items()},
        device=torch.cuda.get_device_name(0))))
    return 0


def _copies():
    import numpy as np
    import torch

    dev = torch.device("cuda")
    arrays = [np.arange(64, dtype=np.int32), np.ones((64, 32), np.int32)] * 3
    ring = torch.empty(sum(a.size for a in arrays), dtype=torch.int32, pin_memory=True)

    def pageable_async():
        return [torch.from_numpy(a).to(dev, non_blocking=True) for a in arrays]

    def pageable_blocking():
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def pin_each():
        return [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in arrays]

    def one_pinned_buffer():  # the step's arrays packed into one pinned copy
        flat = ring.numpy()
        n = 0
        for a in arrays:
            flat[n:n + a.size] = a.reshape(-1)
            n += a.size
        return ring[:n].to(dev, non_blocking=True)

    out = {}
    for name, fn in [("pageable_async", pageable_async), ("pageable_blocking", pageable_blocking),
                     ("pin_each", pin_each), ("one_pinned_buffer", one_pinned_buffer)] * 2:
        ts = []
        for _ in range(20):
            torch.cuda.synchronize()
            torch.cuda._sleep(int(35e6))  # ~20 ms of the card's clock
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
        out.setdefault(name, []).append(statistics.median(ts))
    print(json.dumps(dict(host_ms_median_of_20=out, device=torch.cuda.get_device_name(0))))
    return 0


def _alternate(cs, engine):
    """Decode host ms by staging mode, the modes swapped round by round."""
    from qserve_tpu_torch.layers import sampler
    from qserve_tpu_torch.utils import utils
    from qserve_tpu_torch.worker import model_runner

    spent = [0.0, 0]  # host seconds inside the copies, calls

    def timed(fn):
        def copy(x, device):
            t = time.perf_counter()
            try:
                return fn(x, device)
            finally:
                spent[0] += time.perf_counter() - t
                spent[1] += 1
        return copy

    pinned_copy = timed(utils.to_device)
    runner_pageable = timed(lambda x, device: x.to(device, non_blocking=True))
    sampler_pageable = timed(lambda x, device: x.to(device))
    ms, rounds = {"pinned": [], "pageable": []}, []
    for i, mode in enumerate(["pinned", "pageable", "pageable", "pinned"] * 2):
        pinned = mode == "pinned"
        model_runner.to_device = pinned_copy if pinned else runner_pageable
        sampler.to_device = pinned_copy if pinned else sampler_pageable
        want, _ = cs._add_path_a(engine, f"alt{i}")
        spent[:] = [0.0, 0]
        step_ms = cs._drive(engine, want)["ms"]["decode"]
        ms[mode] += step_ms
        rounds.append(dict(mode=mode, decode_ms_median=statistics.median(step_ms),
                           copy_ms_total=spent[0] * 1e3, copies=spent[1]))
    model_runner.to_device = sampler.to_device = utils.to_device
    print(json.dumps(rounds))
    return ms


if __name__ == "__main__":
    sys.exit(main())
