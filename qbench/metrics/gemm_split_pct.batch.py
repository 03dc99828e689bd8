"""The W4A8 per-channel GEMM launches that split K, in the traced steps: 100 x the program's counter `gemm_split_launches` (launches of K2 or the routed K10 whose tile grid left the SMs idle, so kernels/gemm.py `split_k` cut K among several blocks a tile) over `gemm_launches` (every K2 and K10 launch), both counted by the kernels' wrappers and, for a replayed decode graph, recorded again at each replay. High where decode steps at M <= 128 carry the time; near 0 where 2048-row prompt and mixed steps fill the card's SMs."""

from qbench import counters

LAYER = "kernels"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = counters.share_pct("gemm_split_launches", "gemm_launches")
