"""95th percentile, over every request that finished inside the window, of
(last token time - first token time) / (output tokens - 1)."""

from qbench import readers

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    return readers.p95([1e3 * (r.last - r.first) / (r.n_out - 1)
                        for r in run.finished if r.n_out > 1 and not r.failed])
