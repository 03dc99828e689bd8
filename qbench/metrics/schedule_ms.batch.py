"""Host ms a traced decode step spends in `Scheduler.schedule()` (core/scheduler.py), the program's `engine.schedule` span: the decode batch's slots, preemptions, swap-ins, the step's metadata."""

from qbench import spans

LAYER = "scheduler"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "output_tok_s"
read = spans.per_decode_step_ms("engine.schedule")
