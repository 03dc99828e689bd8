"""The benchmark of the PyTorch/CUDA port (qserve_tpu_torch): one run of one
cell is `python3 qbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout; BENCHMARK.json names the cells.
Nothing here imports JAX or the JAX package."""
