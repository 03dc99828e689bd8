"""Readings that a cell's logit-gap limit is set from (PERF.md).

    python3 qbench/calibrate.py --workload <cell> --seeds 11 12 13 --seconds 10

From the root of a checkout, on the card. For each seed, one run of the
cell as qbench/run.py makes it (a shorter window is fine: what is read is
the sample of finished requests), then on the same sample, through
qbench/check.py's own gaps and judgment: the program's readings (the
numbers the benchmark compares) and the control's (the reference one
precision lower, its first choice at each judged position), each with
whether the cell's limits hold it correct.

Prints one JSON line a seed.
"""

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from qbench import check, registry  # noqa: E402


def readings(cell, seed, requests, device) -> dict:
    """The program's and the control's readings on one run's check sample."""
    spec = cell.traffic["check"]
    picked = check.sample(requests, seed, int(spec["requests"]))
    out = {"requests": len(picked)}
    if not picked:
        return out
    t = time.perf_counter()
    gaps = check.token_gaps(cell.family, cell.config, seed, picked, device,
                            int(spec["scored_tokens"]), control=True)
    out.update(tokens=int(gaps["program"].numel()), check_s=time.perf_counter() - t,
               served=[len(r.tokens) for r in picked])
    for side, g in gaps.items():
        out[f"{side}_correct"] = check.judge(cell, g, len(picked))[0]
        out.update({f"{side}_{name}": f(g) for name, f in check.READINGS.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    a = ap.parse_args(argv)
    from qbench.run import run_cell

    cell = registry.load_cell(a.workload)
    for seed in a.seeds:
        got = {}

        def checker(cell, seed, requests, device):
            got.update(readings(cell, seed, requests, device))
            return True, {}

        start = time.perf_counter()
        out = run_cell(cell, seed, a.seconds, False, "cuda", start, checker=checker)
        line = dict(seed=seed, workload=a.workload, run_s=time.perf_counter() - start,
                    metrics={k: v["value"] for k, v in out["metrics"].items()}, **got)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
