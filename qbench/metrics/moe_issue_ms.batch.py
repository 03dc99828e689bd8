"""Host ms a traced decode step spends in the sparse-MoE blocks (models/llama.py `_moe_mlp`), the program's `model.moe` spans summed over the step's layers: the router and the masked loop's launches over every expert."""

from qbench import spans

LAYER = "model"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("model.moe")
