"""95th percentile, over every request due inside the window, of the end of
the step that returned its first token less the time it was due. Requests
are followed past the window's close; one that failed, or has no first
token when the wait ends, counts as missing every limit (inf; a p95 that
lands on one is reported as 1e9 ms)."""

from qbench import readers

UNIT = "ms"
SOURCE = "host_clock"
MISS_MS = 1e12  # stands for inf in the percentile's arithmetic
REPORTED_MISS_MS = 1e9


def read(run):
    vals = [1e3 * (r.first - r.due) if r.first is not None and not r.failed else MISS_MS
            for r in run.due]
    v = readers.p95(vals)
    return None if v is None else min(v, REPORTED_MISS_MS)
