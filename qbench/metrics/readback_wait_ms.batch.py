"""Host ms a traced decode step spends blocked on the sampled ids' read-back (worker/model_runner.py), the program's `runner.readback` span: the device time the host's launches did not hide."""

from qbench import spans

LAYER = "runner"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("runner.readback")
