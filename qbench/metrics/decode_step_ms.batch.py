"""Host ms around LLMEngine.step() (engine/llm_engine.py) of the window's decode steps, over their count: the step ends in the sampled ids' read-back."""

from qbench import readers

LAYER = "engine"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "output_tok_s"
read = readers.step_ms(("decode",))
