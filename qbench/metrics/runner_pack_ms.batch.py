"""Host ms a traced decode step spends packing its batch (worker/model_runner.py), the program's `runner.pack` span: the metadata walk, `native.pack_decode` and the pinned staging copies to the card, up to the model call."""

from qbench import spans

LAYER = "runner"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("runner.pack")
