"""From process start to the first measured step: imports, the CUDA
context, loading the built kernels, the weights made and quantized, the KV
cache allocated, the warm-up."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
