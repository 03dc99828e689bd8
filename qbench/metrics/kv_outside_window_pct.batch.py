"""The KV cache's page-layer slots that a window layer holds wholly below its window, over all the slots the running sequences hold, in the traced steps: 100 x the scheduler's counter `kv_slots_outside_window` over `kv_slots_held` (core/scheduler.py, counted once a step is scheduled). Keys no later query of that layer reads: the memory a window-aware page allocator would take back."""

from qbench import counters

LAYER = "scheduler"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = counters.share_pct("kv_slots_outside_window", "kv_slots_held")
