"""What the A/B timing scripts (scripts/ab_*.py) share: building a variant
of a kernel source with the committed nvcc flags, timing a call on the
card (device and host time), and the card's name and power limit."""

from __future__ import annotations

import os
import shutil
import subprocess
import time

CSRC = os.path.join("qserve_tpu_torch", "kernels", "csrc")


def build(out_dir, name, csrc, stem, edits=()):
    """Writes csrc/<stem>.cu with the edits ((old, new) pairs, each old
    string found exactly once) and csrc's headers under out_dir/name and
    starts its nvcc. Returns (.so path, process)."""
    from qserve_tpu_torch.kernels import _build

    d = os.path.join(out_dir, name)
    os.makedirs(d)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(csrc, stem + ".cu")) as f:
        src = f.read()
    for a, b in edits:
        assert src.count(a) == 1, (name, a)
        src = src.replace(a, b)
    cu = os.path.join(d, stem + ".cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(d, stem + ".so")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, proc


def device_ms(fn, n=20):
    """Device time of one call: CUDA events around n back-to-back calls
    (the host enqueues ahead of the card, so its own time drops out)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n=200):
    """Host time of one call: n calls without a sync (the card's queue
    absorbs them), then one sync outside the span."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
