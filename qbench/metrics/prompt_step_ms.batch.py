"""Host ms around LLMEngine.step() of the window's steps that carry prompt tokens (prefill, chunk, mixed), over their count."""

from qbench import readers

LAYER = "engine"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "output_tok_s"
read = readers.step_ms(("prefill", "chunk", "mixed"))
