"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It builds one engine (the cell's configuration,
weights made from the seed on the card), warms it up on the cell's own
traffic, drives `LLMEngine.step()` for `--seconds`, and prints one JSON
line last: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, the numbers compared with
their limits (also the last lines on standard error).

With `--trace 1` the measured window runs untraced (its steps give the
host-clock metrics), then torch.profiler traces TRACE_S seconds more of
the same traffic for the device metrics. `correct` comes after both, from
the reference (qbench/check.py), once the program's state is freed.

Exits non-zero, printing no result, without enough CUDA devices, when the
port cannot be imported, or when JAX, flax or the JAX package is loaded in
this process once the window has closed.
"""

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a library the port may use must not load JAX on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

from qbench import registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "qserve_tpu")
GRACE_S = 60.0  # how long requests due in the window are followed past it
# for their first token: one that has none by then, or that failed, fails


@dataclasses.dataclass
class RunView:
    """What the metric files read."""

    sizes: object  # the family's Sizes of the configuration
    family: object  # the configuration's model family (qbench/families/)
    kv_pages: int  # the KV cache's pages
    t0: float
    t1: float
    setup_s: float
    window: list  # Steps of the measured window
    traced: list  # Steps of the traced stretch
    trace: Optional[object]  # tracing.TraceSummary
    due: list  # Requests due inside the window
    finished: list  # Requests finished inside the window


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, start: float,
             args=None, num_pages=None, clock=time.perf_counter, checker=None) -> dict:
    """One run; returns the result line's dict. `args` and `num_pages`
    override the configuration's (small CPU tests); `checker` replaces
    check.check (the calibration reads more than the limit)."""
    import torch

    from qbench import check, harness, tracing
    from qbench.traffic import Traffic

    sizes = cell.family.sizes(cell.config)
    engine = harness.build_engine(cell.family, cell.config, seed, device, args=args,
                                  num_pages=num_pages)
    traffic = Traffic(cell.traffic, seed, sizes.vocab, cell.config["special_token_ids"],
                      epoch_s=seconds)
    drv = harness.Feeder(engine, traffic, clock=clock)
    drv.warm_shapes()
    drv.start()
    if traffic.loop == "closed":
        drv.run(steps=int(cell.traffic["warmup_steps"]))
    else:
        drv.run(until=drv.sched0 + float(cell.traffic["warmup_s"]))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()

    t0 = clock()
    n0 = len(drv.steps)
    drv.run(until=t0 + seconds)
    n1 = len(drv.steps)
    t1 = max(t0 + seconds, drv.steps[-1].t1 if n1 > n0 else t0)
    summary = None
    if trace:
        with tracing.traced(drv) as held:
            drv.run(until=clock() + tracing.TRACE_S)
        summary = held.summary
    n2 = len(drv.steps)
    due = harness.window_requests(drv, t0, t1)
    waiting = [r for r in due if r.first is None and r.done is None]
    drv.run(until=clock() + GRACE_S,
            while_=lambda: any(r.first is None and r.done is None for r in waiting))
    peak = harness.memory_peak(device)

    view = RunView(sizes=sizes, family=cell.family, kv_pages=drv.kv_pages, t0=t0, t1=t1,
                   setup_s=t0 - start, window=drv.steps[n0:n1], traced=drv.steps[n1:n2],
                   trace=summary, due=due, finished=harness.finished_in(drv, t0, t1))
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = registry.load_module("metrics" if trace else "e2e", m["name"], cell.root).read(view)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = len(due)
    failed = sum(1 for r in due if r.failed or r.first is None)

    harness.free_engine(engine)
    del engine, drv.engine
    checked = [r for r in drv.requests.values() if r.done is not None and t0 <= r.done]
    c0 = time.perf_counter()
    correct, checks = (checker or check.check)(cell, seed, checked, device)
    check_s = time.perf_counter() - c0

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [[n[:120], s] for n, s in summary.top_ops(10)],
                            "idle_gaps": summary.top_idle(10)}
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    cell = registry.load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"qbench: {a.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", _PROCESS_START)
    bad = forbidden_modules()
    if bad:
        print(f"qbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    print(f"qbench: the check took {out['check_s']:.1f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
