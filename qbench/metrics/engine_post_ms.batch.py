"""Host ms a traced decode step spends after `Worker.execute_model` returns (engine/llm_engine.py), the program's `engine.post` span: token appends, stop checks, frees, the RequestOutputs."""

from qbench import spans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("engine.post")
