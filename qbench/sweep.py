"""The knee of an open-loop cell: its traffic at a list of fixed rates, one
engine, on the card.

    python3 qbench/sweep.py --config mistral-7b-v0.1.w4a8kv4 --traffic chat-bursty --rates 3 5 7 9 11 13

From the root of a checkout; the configuration and the mix are found by
name, whether or not a cell pairs them yet. For each rate (requests/s): the mix's
warm-up, a window of `--seconds`, then the requests due in it are followed
until they have their first token (at most 60 s), then the engine drains.
One JSON line a rate: the latency tails, the output rate, the requests due
and finished, the largest number of running and waiting requests seen, and
the waiting queue at the window's close (a queue that grows through the
window means the rate is past the knee). The cell's rate is 4/5 of the
highest rate whose queue did not grow. An exception in a step ends that
rate's line with its message; the engine is then built again.
"""

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qbench import harness, registry  # noqa: E402
from qbench.traffic import Traffic  # noqa: E402


def one_rate(engine, family, cfg, traffic, rate, seconds, seed) -> dict:
    tr = copy.deepcopy(traffic)
    tr["rate_per_s"] = rate
    drv = harness.Feeder(engine, Traffic(tr, seed, family.sizes(cfg).vocab,
                                         cfg["special_token_ids"], epoch_s=seconds))
    peak = {"running": 0, "waiting": 0}
    orig_step = drv.step

    def step():
        st = orig_step()
        s = engine.stats()
        peak["running"] = max(peak["running"], s["running"])
        peak["waiting"] = max(peak["waiting"], s["waiting"])
        return st

    drv.step = step
    line = {"rate": rate}
    try:
        drv.warm_shapes()
        drv.start()
        drv.run(until=drv.sched0 + tr["warmup_s"])
        w_start = engine.stats()["waiting"]
        t0 = time.perf_counter()
        n0 = len(drv.steps)
        drv.run(until=t0 + seconds)
        t1 = time.perf_counter()
        w_end = engine.stats()["waiting"]
        due = harness.window_requests(drv, t0, t1)
        waiting = [r for r in due if r.first is None]
        drv.run(until=time.perf_counter() + 60.0,
                while_=lambda: any(r.first is None and r.done is None for r in waiting))
        ttft = [1e3 * (r.first - r.due) for r in due if r.first is not None]
        fin = harness.finished_in(drv, t0, t1)
        tpot = [1e3 * (r.last - r.first) / (r.n_out - 1) for r in fin if r.n_out > 1]
        line.update(
            due=len(due), finished=len(fin), no_first_token=len(due) - len(ttft),
            output_tok_s=sum(s.new_tokens for s in drv.steps[n0:]) / (t1 - t0),
            ttft_p50_ms=float(np.percentile(ttft, 50)) if ttft else None,
            ttft_p95_ms=float(np.percentile(ttft, 95)) if ttft else None,
            tpot_p95_ms=float(np.percentile(tpot, 95)) if tpot else None,
            waiting_at_start=w_start, waiting_at_end=w_end)
        for rid in list(drv.requests):
            if drv.requests[rid].done is None:
                engine.abort_request(rid)
        while engine.has_unfinished_requests():
            engine.step()
    except Exception as e:  # a failed step ends this rate; the caller rebuilds
        line["error"] = f"{type(e).__name__}: {e}"
    line.update(max_running=peak["running"], max_waiting=peak["waiting"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    cfg, traffic = registry.load_config(a.config), registry.load_traffic(a.traffic)
    family = registry.family_of(cfg)
    engine = harness.build_engine(family, cfg, a.seed, "cuda")
    for rate in a.rates:
        line = one_rate(engine, family, cfg, traffic, rate, a.seconds, a.seed)
        line["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
        if "error" in line:
            harness.free_engine(engine)
            engine = harness.build_engine(family, cfg, a.seed, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
