"""Host ms a traced decode step spends in the model call `llama.decode` (models/llama.py), the program's `runner.forward` span: the host issuing every layer's launches and the lm_head; where the card's queue fills, also the host waiting on it."""

from qbench import spans

LAYER = "model"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("runner.forward")
